"""The whole pseudo-label slice of the port against the JAX package,
random weights at a narrow width (embed 128, 4 blocks, head dim 64).

``seed_debug`` and ``seed_pseudo_gt`` of both packages on the same
converted weights and inputs, with the JAX draws replayed into the port
(``test_torch_support.replay_draws``); every output key is compared,
integers exactly (``test_torch_support.EXACT``), floats at the stated
tolerances. Shipped strides (cam 16, maps 4) and exact stride 1.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_support import check_slice  # noqa: E402


@pytest.mark.parametrize("cam_stride,map_stride", [(16, 4), (1, 1)])
def test_slice_matches_jax_random_weights(cam_stride, map_stride):
    check_slice("random", cam_stride, map_stride)
