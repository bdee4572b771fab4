"""The whole pseudo-label slice of the port against the JAX package on
the committed trained fixture ``tools/fixtures/ckpt3k``, at the full
ViT-S width of configs/attnshift_voc12aug.py on a 128x192 disc image.

As ``test_torch_slice_random``: every ``seed_debug``/``seed_pseudo_gt``
key, the JAX draws replayed into the port, shipped strides and stride 1.
The scene holds distinct objects: where two instances' refined maps
agree to float rounding, Stage B's winner-take-all selection is decided
by rounding in either package.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_support import check_slice  # noqa: E402


@pytest.mark.parametrize("cam_stride,map_stride", [(16, 4), (1, 1)])
def test_slice_matches_jax_ckpt3k(cam_stride, map_stride):
    check_slice("ckpt3k", cam_stride, map_stride)
