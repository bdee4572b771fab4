"""The RepPoints cascade's modules of the port against the JAX package.

``core/losses_geom.py`` (every function, with masks and padding),
``models/reppoints.py``: ``contour_points`` on the same Gumbel noise,
``RepPointsPartHead`` on converted weights (losses, refined centers and
their validity, the head's parameter gradients) and ``refine_fg_maps``
(with the JAX package's ``bg_points_override``, and with its own draw
replayed). Inputs are made from numpy seeds on the CPU.

Tolerances: losses and maps to 1e-5 relative (f32 sums in another
order); gradients to 2e-3 of each tensor's largest entry, as
``test_torch_train_step_random.py`` holds the train step's; integer
outputs and the coordinates picked from integer grids exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import close  # noqa: E402

LOSS_REL = 1e-5
GRAD_REL = 2e-3


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _point_sets(seed: int = 0, n: int = 5, p1: int = 7, p2: int = 4):
    rs = np.random.RandomState(seed)
    x = (rs.rand(n, p1, 2) * 50).astype(np.float32)
    y = (rs.rand(n, p2, 2) * 50).astype(np.float32)
    xv = rs.rand(n, p1) > 0.3
    yv = rs.rand(n, p2) > 0.3
    xv[0], yv[1] = False, False  # an object without predictions, one without targets
    ov = np.asarray([True, True, True, False, True])
    return x, y, xv, yv, ov


# ------------------------------------------------------------ losses_geom


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_distance_matches_jax(masked):
    from attentionshift_torch.core import losses_geom as tg
    from attentionshift_tpu.core import losses_geom as jg

    x, y, xv, yv, _ = _point_sets()
    jargs = (x, y, xv, yv) if masked else (x, y)
    want = np.asarray(jg.chamfer_distance(*map(jnp.asarray, jargs)))
    got = tg.chamfer_distance(*_t(*jargs)).numpy()
    close(got, want, LOSS_REL * np.abs(want).max(), what="chamfer_distance")


@pytest.mark.parametrize("with_obj_valid", [False, True])
def test_chamfer_loss_value_and_gradient_match_jax(with_obj_valid):
    """``chamfer_loss`` with padded points on both sides and a padded
    object: its value and its gradient in the predicted points."""
    from attentionshift_torch.core import losses_geom as tg
    from attentionshift_tpu.core import losses_geom as jg

    x, y, xv, yv, ov = _point_sets(seed=1)
    ov = ov if with_obj_valid else None
    kw = dict(loss_weight=0.7)

    def jfn(xx):
        return jg.chamfer_loss(xx, jnp.asarray(y), jnp.asarray(xv), jnp.asarray(yv),
                               None if ov is None else jnp.asarray(ov), **kw)

    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tg.chamfer_loss(xt, *_t(y, xv, yv), None if ov is None else torch.from_numpy(ov), **kw)
    (grad,) = torch.autograd.grad(got, xt)
    close(float(got.detach()), float(want), LOSS_REL * abs(float(want)), what="chamfer_loss")
    close(grad, jgrad, GRAD_REL * float(np.abs(jgrad).max()), what="chamfer_loss grad")


def test_sim_masked_chamfer_loss_matches_jax():
    from attentionshift_torch.core import losses_geom as tg
    from attentionshift_tpu.core import losses_geom as jg

    rs = np.random.RandomState(2)
    n, k, pp, pc, d = 3, 4, 5, 6, 8
    part_pts = (rs.rand(n, k, pp, 2) * 40).astype(np.float32)
    cont = (rs.rand(n, pc, 2) * 40).astype(np.float32)
    base = rs.randn(d).astype(np.float32)
    # features near one direction, so that some pairs pass the 0.85 gate
    part_f = (base + 0.4 * rs.randn(n, k, d)).astype(np.float32)
    cont_f = (base + 0.4 * rs.randn(n, pc, d)).astype(np.float32)
    pv = rs.rand(n, k) > 0.25
    cv = rs.rand(n, pc) > 0.25
    ov = np.asarray([True, False, True])
    args = (part_pts, cont, part_f, cont_f, pv, cv, ov)
    want = float(jg.sim_masked_chamfer_loss(*map(jnp.asarray, args), loss_weight=1.5))
    got = float(tg.sim_masked_chamfer_loss(*_t(*args), loss_weight=1.5))
    assert want > 0
    close(got, want, LOSS_REL * want, what="sim_masked_chamfer_loss")


@pytest.mark.parametrize("y_first,with_valid", [(False, True), (False, False), (True, True)])
def test_pts_border_loss_value_and_gradient_match_jax(y_first, with_valid):
    from attentionshift_torch.core import losses_geom as tg
    from attentionshift_tpu.core import losses_geom as jg

    rs = np.random.RandomState(3)
    pts = (rs.rand(4, 9 * 2) * 120 - 10).astype(np.float32)
    boxes = np.asarray([[10, 10, 60, 80], [0, 20, 100, 50], [30, 30, 40, 40], [0, 0, 0, 0]],
                       np.float32)
    valid = np.asarray([True, True, True, False]) if with_valid else None
    kw = dict(loss_weight=0.5, y_first=y_first)

    def jfn(pp):
        return jg.pts_border_loss(pp, jnp.asarray(boxes),
                                  None if valid is None else jnp.asarray(valid), **kw)

    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pts))
    pt = torch.from_numpy(pts).requires_grad_(True)
    got = tg.pts_border_loss(pt, torch.from_numpy(boxes),
                             None if valid is None else torch.from_numpy(valid), **kw)
    (grad,) = torch.autograd.grad(got, pt)
    assert float(want) > 0
    close(float(got.detach()), float(want), LOSS_REL * float(want), what="pts_border_loss")
    close(grad, jgrad, GRAD_REL * float(np.abs(jgrad).max()), what="pts_border_loss grad")


@pytest.mark.parametrize("mode", ["in_batch", "unpaired", "paired"])
def test_info_nce_loss_matches_jax(mode):
    from attentionshift_torch.core import losses_geom as tg
    from attentionshift_tpu.core import losses_geom as jg

    rs = np.random.RandomState(4)
    q = rs.randn(6, 8).astype(np.float32)
    pk = (q + 0.3 * rs.randn(6, 8)).astype(np.float32)
    neg = {"in_batch": None, "unpaired": rs.randn(5, 8).astype(np.float32),
           "paired": rs.randn(6, 5, 8).astype(np.float32)}[mode]
    paired = mode == "paired"
    want = float(jg.info_nce_loss(jnp.asarray(q), jnp.asarray(pk),
                                  None if neg is None else jnp.asarray(neg), 0.2, paired))
    got = float(tg.info_nce_loss(*_t(q, pk), None if neg is None else torch.from_numpy(neg), 0.2,
                                 paired))
    close(got, want, LOSS_REL * abs(want), what=f"info_nce_loss {mode}")


# ------------------------------------------------------------- reppoints


def _contour_gumbel(key, masks):
    """The Gumbel noise ``contour_points`` draws inside the JAX package:
    one key per mask, ``split(key, G)`` (reppoints.py:66), over H*W."""
    g, h, w = masks.shape
    return torch.stack([torch.from_numpy(np.array(jax.random.gumbel(k, (h * w,))))
                        for k in jax.random.split(key, g)])


def _masks(b=1, g=3, h=128, w=128):
    m = np.zeros((b, g, h, w), np.uint8)
    m[:, 0, 16:96, 16:96] = 1
    m[:, 1, 32:104, 40:112] = 1
    m[:, 1, 60:70, 60:70] = 0  # a hole: an inner contour too
    return m  # the last instance is empty (padding)


def test_contour_points_match_jax_on_the_same_noise():
    """The same Gumbel noise gives the same contour points and validity;
    the empty mask gives no valid point."""
    from attentionshift_torch.models.reppoints import contour_points
    from attentionshift_tpu.models import reppoints as jrp

    masks = _masks()[0]
    key = jax.random.PRNGKey(7)
    jxy, jval = jrp.contour_points(jnp.asarray(masks), 12, key)
    xy, val = contour_points(torch.from_numpy(masks), 12, gumbel=_contour_gumbel(key, masks))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(xy.numpy(), np.asarray(jxy))
    assert val[:2].all() and not val[2].any()


def _head_inputs(seed: int = 0, b: int = 2, g: int = 3, p: int = 2, hf: int = 8, wf: int = 8,
                 c: int = 32):
    rs = np.random.RandomState(seed)
    h, w = hf * 16, wf * 16
    feats = rs.randn(b, hf, wf, c).astype(np.float32)
    boxes = np.tile(np.asarray([[[10, 10, 100, 100], [30, 30, 120, 110], [0, 0, 0, 0]]],
                               np.float32), (b, 1, 1))
    centers = (rs.rand(b, g, p, 2) * 90 + 15).astype(np.float32)
    cval = np.tile(np.asarray([[[True, True], [True, False], [False, False]]]), (b, 1, 1))
    gval = np.tile(np.asarray([[True, True, False]]), (b, 1))
    masks = _masks(b, g, h, w)
    fg = (masks * (0.6 + 0.4 * rs.rand(b, g, h, w))).astype(np.float32)
    key = jax.random.PRNGKey(1)
    from attentionshift_tpu.models import reppoints as jrp

    cont = [jrp.contour_points(jnp.asarray(masks[i]), 16, k)
            for i, k in enumerate(jax.random.split(key, b))]
    cont_xy = np.stack([np.asarray(c[0]) for c in cont])
    cont_val = np.stack([np.asarray(c[1]) for c in cont])
    return feats, boxes, centers, cval, gval, masks, fg, cont_xy, cont_val


@pytest.fixture(scope="module")
def head_case():
    """The JAX ``RepPointsPartHead`` (2 convs, 5 points) on random flax
    parameters, its outputs and parameter gradients, and the port's head
    on the converted parameters."""
    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.models.reppoints import RepPointsPartHead
    from attentionshift_tpu.models import reppoints as jrp

    args = _head_inputs()
    jargs = tuple(map(jnp.asarray, args))
    jhead = jrp.RepPointsPartHead(num_points=5, stacked_convs=2)
    shapes = jax.eval_shape(lambda: jhead.init(jax.random.PRNGKey(0), *jargs))
    rs = np.random.RandomState(5)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: ((1.0 + 0.1 * rs.randn(*s.shape)) if "scale" in jax.tree_util.keystr(path)
                         else 0.05 * rs.randn(*s.shape)).astype(np.float32), shapes)

    def loss_fn(v):
        out = jhead.apply(v, *jargs)
        return sum(out.losses.values()), out

    (_, jout), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    sd = flax_to_torch({"params": {"reppoints_head_0": params["params"]}})
    port = RepPointsPartHead(in_channels=32, num_points=5, stacked_convs=2)
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    out = port(*_t(*args))
    total = sum(out.losses.values())
    names = [n for n, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(total, list(port.parameters()))))
    jg = flax_to_torch({"params": {"reppoints_head_0": jgrads["params"]}})
    return dict(out=out, jout=jout, grads=grads, jgrads={k.split(".", 1)[1]: v for k, v in jg.items()})


def test_reppoints_head_losses_match_jax(head_case):
    out, jout = head_case["out"], head_case["jout"]
    assert set(out.losses) == set(jout.losses) == {
        "loss_rp_border", "loss_rp_chamfer_sem", "loss_rp_chamfer_contour", "loss_rp_cls"}
    for k, v in jout.losses.items():
        close(float(out.losses[k].detach()), float(v), LOSS_REL * abs(float(v)), what=k)
        assert float(v) > 0, k


def test_reppoints_head_refined_centers_match_jax(head_case):
    out, jout = head_case["out"], head_case["jout"]
    np.testing.assert_array_equal(out.new_valid.numpy(), np.asarray(jout.new_valid))
    close(out.new_centers, jout.new_centers, 1e-4, what="new_centers")  # pixels
    assert not out.new_centers.requires_grad
    assert not out.new_valid[:, 2].any() and not out.new_valid[:, 1, 1].any()


def test_reppoints_head_gradients_match_jax(head_case):
    grads, jgrads = head_case["grads"], head_case["jgrads"]
    assert set(grads) == set(jgrads)
    for name, ref in jgrads.items():
        ref = ref.numpy()
        assert np.abs(ref).max() > 0, name
        close(grads[name], ref, GRAD_REL * np.abs(ref).max(), what=f"grad {name}")


def _refine_inputs():
    """Patch features whose halves differ (distinct regions, no Stage-B
    near-tie), two instances' fg maps, refined centers, Stage-B-like
    prototypes; instance 2 is padding."""
    rs = np.random.RandomState(1)
    d, hp, wp, h, w = 8, 8, 12, 128, 192
    feat = (0.05 * rs.randn(d, hp, wp)).astype(np.float32)
    feat[0, :4, :6] += 2.0
    feat[1, 4:, 6:] += 2.0
    feat[2, :, 9:] += 1.0
    fg = np.zeros((3, h, w), np.float32)
    fg[0, :64, :96] = 1.0
    fg[1, 64:, 96:] = 0.8
    boxes = np.asarray([[0, 0, 95, 63], [96, 64, 191, 127], [0, 0, 0, 0]], np.float32)
    centers = np.asarray([[[32, 16], [80, 40]], [[120, 96], [170, 110]], [[0, 0], [0, 0]]],
                         np.float32)
    cval = np.asarray([[True, True], [True, False], [False, False]])
    fp = np.stack([feat[:, :4, :6].mean((1, 2)), feat[:, 4:, 6:].mean((1, 2)),
                   0.05 * rs.randn(d), 0.05 * rs.randn(d)]).astype(np.float32)
    bp = (0.05 * rs.randn(3, d)).astype(np.float32)
    valid = np.asarray([True, True, False])
    return fg, feat, boxes, centers, cval, fp, bp, valid


@pytest.mark.parametrize("draw", ["override", "replayed"])
def test_refine_fg_maps_matches_jax(draw):
    """``refine_fg_maps`` on the same inputs: with the JAX package's
    ``bg_points_override``, and with its own background draw replayed
    from the JAX key (the Gumbel noise of ``topk_in_mask``). The padding
    instance keeps its old map; the masks are equal."""
    from attentionshift_torch.models.reppoints import refine_fg_maps
    from attentionshift_tpu.models import reppoints as jrp

    args = _refine_inputs()
    h, w = args[0].shape[-2:]
    key = jax.random.PRNGKey(3)
    override = np.asarray([[0.1, 0.2], [0.9, 0.3], [0.5, 0.95], [0.2, 0.8], [0.7, 0.6]],
                          np.float32) if draw == "override" else None
    jnew, jmasks = jrp.refine_fg_maps(*map(jnp.asarray, args), key, pos_mask_thr=0.35,
                                      bg_points_override=None if override is None
                                      else jnp.asarray(override))
    kw = (dict(bg_points_override=torch.from_numpy(override)) if override is not None else
          dict(gumbel=torch.from_numpy(np.array(jax.random.gumbel(key, (h * w,))))))
    new, masks = refine_fg_maps(*_t(*args), pos_mask_thr=0.35, **kw)
    close(new, jnew, LOSS_REL, what="new fg maps")
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    np.testing.assert_array_equal(new[2].numpy(), args[0][2])
    assert masks[0, :64, :96].float().mean() > masks[0, 64:].float().mean()
