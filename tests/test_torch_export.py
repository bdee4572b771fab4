"""The serving export of the port on the CPU: the twin of
``tests/test_tools_misc.py::test_export_stablehlo_roundtrip``, and the
attention custom ops that the exported graph holds.

``attentionshift_torch.tools.deployment.export_program`` runs in-process on
the JAX test's ``TINY_CFG`` (the detector) and on a narrow Mask R-CNN
config: it exports ``simple_test`` with ``torch.export``, saves the program,
reloads it and holds every output to the live model's at 1e-5, as the JAX
tool does through StableHLO.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from attentionshift_torch.ops import attention  # noqa: E402
from attentionshift_torch.tools.deployment import export_program as ep  # noqa: E402

# tests/test_tools_misc.py's TINY_CFG, which the JAX tool's test exports
TINY_CFG = """
model = dict(
    num_classes=20, embed_dim=48, depth=4, num_heads=6, out_indices=(0, 1, 2, 3),
    img_size=64, point_tokens=10, cam_layer=3, use_remat=False, max_gt=4,
    cam_stride=4, ccl_iters=8, num_mask_point_gt=4, corr_size=3,
    mean_shift_times=2, num_semantic_points=2, rpn_channels=16,
    num_proposals=16, rpn_nms_pre=16, rcnn_samples=8, mask_sample_cap=4,
    test_max_per_img=5,
)
data = dict(test_scale=(96, 160), max_gt=4)
"""
MRCNN_CFG = """
model_type = "mask_rcnn"
model = dict(num_classes=5, rpn_channels=16, num_proposals=20, rpn_nms_pre=40, rcnn_samples=16,
             mask_sample_cap=8, depths=(1, 1, 1, 1), test_max_per_img=5)
data = dict(test_scale=(64, 96), max_gt=4)
"""


def _ops(program) -> list[str]:
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


@pytest.mark.parametrize("weights_as_args", [False, True])
def test_export_program_roundtrip(tmp_path, capsys, weights_as_args):
    """``simple_test`` of TINY_CFG at 96x160: saved, reloaded, every output
    within 1e-5 of the live model's; the four plain-attention blocks are
    the custom op and NMS is a ``while_loop`` in the graph. Baked weights
    make the artifact large; as arguments they stay out of it."""
    cfg = tmp_path / "tiny.py"
    cfg.write_text(TINY_CFG)
    out = tmp_path / "det.pt2"
    argv = [str(cfg), "--out", str(out), "--scale", "96", "160", "--device", "cpu"]
    res = ep.main(argv + (["--weights-as-args"] if weights_as_args else []))
    assert "round-trip check OK" in capsys.readouterr().out
    ops = _ops(res["program"])
    assert ops.count("attentionshift.attention_plain.default") == 4
    assert "attentionshift.attention_capture.default" not in ops
    assert ops.count("while_loop") >= 1
    if weights_as_args:
        assert out.stat().st_size < 10_000_000
        assert not res["program"].state_dict
    else:
        assert out.stat().st_size > 1_000_000  # weights baked in
    from test_torch_support import drop_weights

    drop_weights(tmp_path)


def test_export_program_mask_rcnn(tmp_path, capsys):
    """``model_type = "mask_rcnn"``: the refinement model's ``simple_test``
    exports (its RoI level selection has fixed shapes) and round-trips at
    the config's test bucket; its outputs keep their NamedTuple type."""
    from attentionshift_torch.models.mask_rcnn import MaskRCNNTestOutputs

    cfg = tmp_path / "mrcnn.py"
    cfg.write_text(MRCNN_CFG)
    out = tmp_path / "mrcnn.pt2"
    res = ep.main([str(cfg), "--out", str(out), "--device", "cpu"])
    assert "round-trip check OK" in capsys.readouterr().out
    assert res["hw"] == (64, 96)
    img = torch.zeros((1, 64, 96, 3))
    got = torch.export.load(str(out)).module()(img, torch.tensor([[96.0, 64.0]]))
    assert isinstance(got, MaskRCNNTestOutputs)
    assert "nonzero" not in " ".join(_ops(res["program"]))
    from test_torch_support import drop_weights

    drop_weights(tmp_path)


@pytest.mark.parametrize("op,n_out", [("attention_plain", 2), ("attention_capture", 3)])
def test_attention_ops_fake_shapes(op, n_out):
    """The fake implementations give what the CUDA implementations allocate
    (``flash_forward``, ``_mean``): ``out`` like q, the row log2-sum-exp
    (B, H, T) f32, the head mean (B, T, T) in q's dtype, on q's device;
    ``opcheck`` holds the fake and the autograd registration to the CPU
    implementation."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fn = getattr(torch.ops.attentionshift, op)
    b, h, t, d = 2, 6, 300, 64
    with FakeTensorMode():
        q = torch.empty(b, h, t, d, dtype=torch.bfloat16, device="cuda")
        outs = fn(q, q, q, 200, 230)
    want = [((b, h, t, d), torch.bfloat16), ((b, h, t), torch.float32)]
    if n_out == 3:
        want.insert(1, ((b, t, t), torch.bfloat16))
    assert [(tuple(o.shape), o.dtype) for o in outs] == want
    assert all(o.device.type == "cuda" for o in outs)
    rs = np.random.RandomState(0)
    qkv = [torch.from_numpy(rs.randn(1, 2, 40, 64).astype(np.float32)).requires_grad_(True)
           for _ in range(3)]
    torch.library.opcheck(fn, (*qkv, 30, 35))


def test_attention_flop_count():
    """``FlopCounterMode`` counts each op as 4 B H T^2 d, the count of
    ``chip_smoke.py``'s bound of kernel #2."""
    from torch.utils.flop_counter import FlopCounterMode

    q = torch.zeros(1, 6, 50, 64)
    with FlopCounterMode(display=False) as fc:
        attention.attention_no_capture(q, q, q)
        attention.attention_with_capture(q, q, q)
    counts = fc.get_flop_counts()["Global"]
    assert counts[torch.ops.attentionshift.attention_plain] == 4 * 6 * 50 * 50 * 64
    assert counts[torch.ops.attentionshift.attention_capture] == 4 * 6 * 50 * 50 * 64
