"""The port's Swin backbone against the JAX package's, on the CPU.

``models/swin.py``: window partition and reverse, the relative position
index and the shift mask (bitwise); ``WindowAttention`` with and without
the shift mask; the feature pyramid and the attnshift contract on
converted weights (embed 32, depths (1, 1, 2, 1), heads (2, 2, 4, 4),
window 4, at 64x64, where the last stage's 2x2 map clamps the window to
2, and at 128x128); the gradient of a scalar of the outputs against
``jax.grad``; ``candidate_boxes`` on both packages' Swin outputs; and the
Swin config through the port's ``tools.train.build`` against the JAX
``build_model``. Inputs and weights are made from numpy seeds.

Tolerances: f32 on both sides, sums in another order: outputs to 1e-5 of
each tensor's largest magnitude (2e-5 through the whole backbone);
gradients to 2e-3 of each tensor's largest entry, as the train step's
tests hold theirs; boxes to 1e-3 px + 1e-5 of the coordinate (a CAM
threshold crossed by an f32 last bit moves a box by whole cells, which
the seeded inputs here do not meet).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import REPO, close  # noqa: E402

SMALL = dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 4), window_size=4)
HOOK = dict(attnshift=True, point_tokens=10, num_classes=5, global_blocks=2)
OUT_REL = 1e-5
NET_REL = 2e-5
GRAD_REL = 2e-3


def _variables(model, *args, seed: int = 0, scale: float = 0.1):
    """Flax variables of ``model`` applied to ``args`` filled from numpy:
    N(0, scale) kernels, biases, tables and tokens, 1 + N(0, 0.1) norm
    scales."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        return (scale * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _rel(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    close(got, want, rel * max(np.abs(want).max(), 1e-30), what=what)


def test_window_partition_and_reverse_match_jax():
    from attentionshift_torch.models import swin as ts
    from attentionshift_tpu.models import swin as js

    x = np.random.RandomState(0).randn(2, 8, 12, 3).astype(np.float32)
    w = ts.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(w.numpy(), np.asarray(js.window_partition(jnp.asarray(x), 4)))
    back = ts.window_reverse(w, 4, 8, 12)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(js.window_reverse(jnp.asarray(w.numpy()), 4, 8, 12)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("h,w,ws,shift", [(8, 8, 4, 2), (16, 12, 4, 2), (28, 42, 7, 3),
                                          (224, 336, 7, 3)])
def test_relative_index_and_shift_mask_match_jax(h, w, ws, shift):
    """Bitwise: the index table and the mask (Swin's stage 0 at 896x1344
    among them)."""
    from attentionshift_torch.models import swin as ts
    from attentionshift_tpu.models import swin as js

    np.testing.assert_array_equal(ts._relative_position_index(ws), js._relative_position_index(ws))
    np.testing.assert_array_equal(ts._shift_mask(h, w, ws, shift), js._shift_mask(h, w, ws, shift))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "shift-mask"])
def test_window_attention_matches_jax(masked):
    """Output and captured head mean of one windowed attention (4 windows
    of 16 tokens, 2 heads of 16), with the bias table and the mask."""
    from attentionshift_torch.models import swin as ts
    from attentionshift_tpu.models import swin as js

    rs = np.random.RandomState(1)
    x = rs.randn(4, 16, 32).astype(np.float32)
    mask = js._shift_mask(8, 8, 4, 2) if masked else None
    jm = js.WindowAttention(2, 4)
    jmask = None if mask is None else jnp.asarray(mask)
    variables = _variables(jm, jnp.asarray(x), jmask, True, seed=1, scale=0.3)
    jout, jattn = jm.apply(variables, jnp.asarray(x), jmask, True)
    tm = ts.WindowAttention(32, 2, 4)
    p = variables["params"]
    sd = {"relative_position_bias_table": p["relative_position_bias_table"],
          "qkv.weight": p["qkv"]["kernel"].T, "qkv.bias": p["qkv"]["bias"],
          "proj.weight": p["proj"]["kernel"].T, "proj.bias": p["proj"]["bias"]}
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    out, attn = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), True)
    _rel(out.detach(), jout, OUT_REL, "out")
    _rel(attn, jattn, OUT_REL, "attn")


def _both(img_hw, attnshift=True, seed=0):
    """The JAX module, its random variables, the port's module with them
    loaded (f32, CPU) and the seeded image."""
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.models.swin import SwinTransformer
    from attentionshift_tpu.models.swin import SwinTransformer as JSwin

    kw = dict(SMALL, **(HOOK if attnshift else {}))
    img = np.random.RandomState(seed).randn(1, *img_hw, 3).astype(np.float32)
    jm = JSwin(**kw)
    variables = _variables(jm, jnp.asarray(img), seed=seed)
    tm = SwinTransformer(**kw, img_size=img_hw, device="cpu")
    load_flax(tm, jax.tree.map(np.asarray, variables), "swin")
    return jm, variables, tm, img


@pytest.mark.parametrize("attnshift", [False, True], ids=["pyramid", "attnshift"])
@pytest.mark.parametrize("side", [64, 128])
def test_swin_matches_jax_on_converted_weights(side, attnshift):
    """The pyramid (4 stages) and, with the hook, every key of the ViT
    engine's contract, on one seeded flax tree."""
    jm, variables, tm, img = _both((side, side), attnshift)
    want = jm.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    assert set(got) == set(want)
    assert len(got["feature"]) == 4
    for i, (a, b) in enumerate(zip(got["feature"], want["feature"])):
        _rel(a, b, NET_REL, f"feature[{i}]")
    if attnshift:
        t = 1 + (side // 32) ** 2 + HOOK["point_tokens"]
        assert tuple(got["attns"].shape) == (2, 1, t, t)
        assert float(got["attns"][:, :, 0].abs().max()) == 0.0  # the zero cls row
        for k in ("attns", "last_feat", "point_tokens", "outputs_class", "outputs_coord"):
            _rel(got[k], want[k], NET_REL, k)


def test_swin_gradient_matches_jax():
    """d/dparams of a weighted sum of ``outputs_class``, ``outputs_coord``
    and ``last_feat`` (the captured maps carry no gradient), every
    parameter tensor."""
    from attentionshift_torch.convert import flax_to_torch

    jm, variables, tm, img = _both((64, 64))
    rs = np.random.RandomState(5)
    w = {k: rs.randn(*s).astype(np.float32) for k, s in (
        ("outputs_class", (1, 10, 5)), ("outputs_coord", (1, 10, 2)), ("last_feat", (1, 5, 256)))}

    jgrad = jax.grad(lambda v: sum(
        jnp.sum(o * w[k]) for k, o in jm.apply(v, jnp.asarray(img)).items() if k in w))(variables)
    out = tm(torch.from_numpy(img))
    sum((out[k] * torch.from_numpy(w[k])).sum() for k in w).backward()
    want = flax_to_torch(jax.tree.map(np.asarray, jgrad), "swin")
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():  # no gradient reaches the first three out_norms: zeros in JAX
        _rel(torch.zeros_like(p) if p.grad is None else p.grad, want[name], GRAD_REL, name)


def test_candidate_boxes_on_swin_outputs_match_jax():
    """Stage A on both packages' Swin outputs at 128x128: the rollout of the
    captured maps, then ``candidate_boxes`` at cam stride 8."""
    from attentionshift_torch.pseudo.engine import candidate_boxes
    from attentionshift_torch.pseudo.rollout import attention_rollout_point_rows
    from attentionshift_tpu.pseudo.engine import candidate_boxes as jcandidate_boxes
    from attentionshift_tpu.pseudo.rollout import attention_rollout_point_rows as jrollout

    jm, variables, tm, img = _both((128, 128))
    want = jm.apply(variables, jnp.asarray(img))
    with torch.no_grad():
        got = tm(torch.from_numpy(img))
    tokens = np.asarray([0, 1, 7], np.int32)
    points = np.asarray([[40.0, 40.0], [90.0, 80.0], [10.0, 120.0]], np.float32)
    jroll = jrollout(want["attns"], HOOK["point_tokens"])
    jboxes, jcams = jcandidate_boxes(jroll[:, 0], jnp.asarray(tokens), jnp.asarray(points),
                                     (4, 4), (128, 128), cam_stride=8, ccl_iters=8)
    roll = attention_rollout_point_rows(got["attns"], HOOK["point_tokens"])
    boxes, cams = candidate_boxes(roll[:, 0], torch.from_numpy(tokens), torch.from_numpy(points),
                                  (4, 4), (128, 128), cam_stride=8, ccl_iters=8)
    _rel(cams, jcams, NET_REL, "cams")
    jboxes = np.asarray(jboxes)
    assert boxes.shape == jboxes.shape == (3, 2, 4)
    close(boxes.numpy(), jboxes, 1e-3, 1e-5, what="candidate boxes")


def test_swin_config_builds_what_the_jax_cli_builds(tmp_path):
    """``configs/attnshift_voc12aug_swin.py``: no code of either package
    reads ``backbone_type``. The JAX ``tools/train.py::build_model`` builds
    the ViT detector on it; both CLIs then read ``cfg.model.depth``, which
    the config does not set, so the port's ``tools.train.build`` raises
    ``AttributeError`` there as the JAX CLI does (``tools/train.py`` reads
    ``int(cfg.model.depth)`` for the layer decay). Given ``model.depth``,
    the port builds what the JAX ``build_model`` builds: the same parameter
    names and shapes, through the flax conversion, and no Swin module."""
    import importlib.util

    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.tools import train as cli
    from attentionshift_tpu.config import Config
    from test_torch_support import inputs, voc_tree

    data = voc_tree(tmp_path / "VOC2012")
    cfg = tmp_path / "swin.py"
    cfg.write_text(f"""
_base_ = [{REPO + "/configs/attnshift_voc12aug_swin.py"!r}]
data = dict(train=dict(ann_file={data['ann_file']!r}, img_prefix={data['img_prefix']!r}),
            batch_size=1, num_threads=1)
""")
    spec = importlib.util.spec_from_file_location("jax_train_cli", REPO + "/tools/train.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcfg = Config.fromfile(str(cfg))
    assert jcfg.backbone_type == "swin"
    with pytest.raises(AttributeError, match="depth"):
        jcfg.model.depth
    assert "depth=int(cfg.model.depth)" in open(REPO + "/tools/train.py").read()
    with pytest.raises(AttributeError, match="depth"):
        cli.build(cli.parse_args([str(cfg), "--work-dir", str(tmp_path / "w0"), "--device",
                                  "cpu"]))

    jm = jcli.build_model(jcfg)
    assert type(jm).__name__ == "AttnShiftDetector"
    args = inputs(64, 64, int(jcfg.model.max_gt), 2)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "sampling": key, "dropout": key},
                                            *map(jnp.asarray, args)))
    want = flax_to_torch(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    run = cli.build(cli.parse_args([str(cfg), "--work-dir", str(tmp_path / "w"), "--device",
                                    "cpu", "--cfg-options", f"model.depth={jm.depth}"]))
    assert type(run.model).__name__ == "AttnShiftDetector"
    got = run.model.state_dict()
    assert set(got) == set(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in got)
    assert not any("swin" in type(m).__name__.lower() for m in run.model.modules())
