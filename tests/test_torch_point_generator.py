"""The port's sampling, hull, supervision-point generator and deformable
attention against the JAX package's, on the CPU.

``ops/sampling.py::grid_sample_bilinear`` in both ``align_corners``
modes (and against ``F.grid_sample``), ``models/point_generator.py``
(``convex_hull_mask`` with generic, collinear, duplicate and
image-scale point sets; ``SupervisionPointGenerator``) and
``models/deformable_attention.py`` on converted random weights, forward
and gradients. Inputs and weights are made from numpy seeds.

Tolerances: hull masks, core regions and keep flags exactly; samples
and contour points to 1e-5 of the largest magnitude (four f32 products
summed); coverage scores to 1e-6 (ratios of integer counts); the
deformable attention's output to 1e-4 of its largest entry and its
gradients to 1e-4 of each gradient's largest entry (f32 convolutions,
LayerNorms and a softmax in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import close, random_variables  # noqa: E402

REL = 1e-5
MODULE_REL = 1e-4


def _rel(got, want, rel, what=""):
    want = np.asarray(want, np.float64)
    close(got, want, rel * max(np.abs(want).max(), 1e-30), what=what)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape", [(3, 7, 9), (2, 1, 5)])
def test_grid_sample_bilinear_matches_jax(align_corners, shape):
    """Points inside, on the border and outside the image (zero padding)."""
    import torch.nn.functional as F

    from attentionshift_torch.ops.sampling import grid_sample_bilinear
    from attentionshift_tpu.ops.sampling import grid_sample_bilinear as jgs

    rs = np.random.RandomState(sum(shape) + align_corners)
    img = rs.randn(*shape).astype(np.float32)
    grid = (rs.rand(4, 5, 2) * 2.6 - 1.3).astype(np.float32)
    grid[0, :2] = [[-1.0, -1.0], [1.0, 1.0]]
    got = grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid), align_corners)
    want = np.asarray(jgs(jnp.asarray(img), jnp.asarray(grid), align_corners))
    assert tuple(got.shape) == (shape[0], 4, 5)
    _rel(got.numpy(), want, REL)
    ref = F.grid_sample(torch.from_numpy(img)[None], torch.from_numpy(grid)[None],
                        align_corners=align_corners, padding_mode="zeros")[0]
    _rel(got.numpy(), ref.numpy(), REL)


def test_point_sample_matches_jax():
    from attentionshift_torch.ops.sampling import point_sample
    from attentionshift_tpu.ops.sampling import point_sample as jps

    rs = np.random.RandomState(0)
    feats = rs.randn(2, 3, 6, 8).astype(np.float32)
    pts = (rs.rand(2, 7, 2) * 1.2 - 0.1).astype(np.float32)
    _rel(point_sample(torch.from_numpy(feats), torch.from_numpy(pts)).numpy(),
         np.asarray(jps(jnp.asarray(feats), jnp.asarray(pts))), REL)


def _hull_sets():
    rs = np.random.RandomState(0)
    sets = [rs.uniform(4, 44, (7, 2)) for _ in range(4)]
    sets.append(np.asarray([[4, 4], [10, 10], [16, 16], [22, 22], [7, 7], [13, 13], [19, 19.0]]))
    sets.append(np.asarray([[30, 8], [30, 8], [12, 30], [12, 30], [40, 40], [30, 8], [12, 30.0]]))
    sets.append(np.asarray([[20, 5], [20, 40], [20, 22], [20, 9], [20, 33], [20, 14], [20, 27.]]))
    sets.append(np.full((7, 2), 17.5))
    return np.stack(sets).astype(np.float32)


def test_convex_hull_mask_matches_jax():
    """Generic sets, a collinear diagonal, duplicated vertices, a vertical
    segment and a single repeated point: each mask equal to JAX's, alone
    and in one batched call."""
    from attentionshift_torch.models.point_generator import convex_hull_mask
    from attentionshift_tpu.models.point_generator import convex_hull_mask as jhull

    sets = _hull_sets()
    batch = convex_hull_mask(torch.from_numpy(sets), (48, 48), 1.0).numpy()
    for i, pts in enumerate(sets):
        want = np.asarray(jhull(jnp.asarray(pts), (48, 48), 1.0))
        got = convex_hull_mask(torch.from_numpy(pts), (48, 48), 1.0).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"set {i}")
        np.testing.assert_array_equal(batch[i], want, err_msg=f"batch set {i}")
    assert batch[4].sum() > 0  # the collinear set keeps its band


def test_convex_hull_mask_at_image_scale_matches_jax():
    """Contours at x ~ 1344 of an 800x1344 image on the stride-4 raster,
    where the start vertex's argmin(x * 1e6 + y) loses its y term to f32
    spacing, with ties between equal x."""
    from attentionshift_torch.models.point_generator import convex_hull_mask
    from attentionshift_tpu.models.point_generator import convex_hull_mask as jhull

    rs = np.random.RandomState(1)
    sets = rs.uniform(0, 1, (6, 9, 2)) * [120, 90] + [1200, 300]
    sets[:, 0, 0] = sets[:, 1, 0] = sets[:, :, 0].min(1)  # tied leftmost x
    sets = sets.astype(np.float32)
    got = convex_hull_mask(torch.from_numpy(sets), (200, 336), 4.0).numpy()
    want = np.stack([np.asarray(jhull(jnp.asarray(p), (200, 336), 4.0)) for p in sets])
    np.testing.assert_array_equal(got, want)
    assert (got.sum((1, 2)) > 0).all()


def _field(k, hf, wf, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(2 * k, hf, wf) * 0.6).astype(np.float32)


@pytest.mark.parametrize("case", ["square", "random"])
def test_supervision_point_generator_matches_jax(case):
    """The JAX test's constant-square field (overlapping parts of one
    object, a lone part, an invalid slot) and a random field with 3
    objects of 3 parts."""
    from attentionshift_torch.models.point_generator import SupervisionPointGenerator
    from attentionshift_tpu.models.point_generator import SupervisionPointGenerator as JGen

    kw = dict(point_strides=16, mask_thr=0.5, point_thr=0.3, raster_stride=4)
    if case == "square":
        square = np.asarray([[-12, -12], [12, -12], [12, 12], [-12, 12]], np.float32) / 16.0
        field = np.tile(square.reshape(-1)[:, None, None], (1, 4, 4)).astype(np.float32)
        init = np.asarray([[20.0, 20.0], [26.0, 22.0], [50.0, 50.0], [0.0, 0.0]], np.float32)
        obj = np.asarray([0, 0, 1, 1], np.int32)
        valid = np.asarray([True, True, True, False])
        n_obj = 2
    else:
        field = _field(9, 5, 6, 3)
        rs = np.random.RandomState(4)
        init = (rs.rand(9, 2) * [96, 80]).astype(np.float32)
        obj = np.repeat(np.arange(3), 3).astype(np.int32)
        valid = rs.rand(9) > 0.2
        n_obj = 3
    want = jax.jit(lambda *a: JGen(**kw)(*a, num_objects=n_obj))(
        jnp.asarray(field), jnp.asarray(init), jnp.asarray(obj), jnp.asarray(valid))
    got = SupervisionPointGenerator(**kw)(torch.from_numpy(field), torch.from_numpy(init),
                                          torch.from_numpy(obj), torch.from_numpy(valid), n_obj)
    _rel(got.pred_points.numpy(), np.asarray(want.pred_points), REL)
    np.testing.assert_array_equal(got.core_regions.numpy(), np.asarray(want.core_regions))
    close(got.scores.numpy(), np.asarray(want.scores), 1e-6)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    if case == "square":
        assert got.keep.tolist() == [True, True, True, False]


@pytest.mark.parametrize("b,h,w,c,heads", [(1, 8, 8, 16, 2), (2, 5, 7, 24, 4)])
def test_deformable_conv_attention_matches_jax(b, h, w, c, heads):
    """Converted random weights: the output, the input gradient and every
    parameter gradient of a weighted sum of the output against
    ``jax.grad``."""
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.models.deformable_attention import DeformableConvAttention
    from attentionshift_tpu.models.deformable_attention import DeformableConvAttention as JDCA

    rs = np.random.RandomState(b + h)
    x = rs.randn(b, h, w, c).astype(np.float32)
    wt = rs.randn(b, h, w, c).astype(np.float32)
    jm = JDCA(n_heads=heads, kernel_size=3)
    variables = random_variables(jm, (x,), seed=b, scale=0.3)
    tm = load_flax(DeformableConvAttention(c, n_heads=heads, device="cpu"), variables,
                   "deformable_attention")

    def jloss(v, xx):
        return (jm.apply(v, xx) * wt).sum()

    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    jg_v, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(variables, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    _rel(out.detach().numpy(), want, MODULE_REL, "output")
    (out * torch.from_numpy(wt)).sum().backward()
    _rel(xt.grad.numpy(), np.asarray(jg_x), MODULE_REL, "d input")
    from attentionshift_torch.convert import flax_to_torch

    want_g = flax_to_torch(jax.tree.map(np.asarray, jg_v), "deformable_attention")
    got_g = dict(tm.named_parameters())
    assert set(want_g) == set(got_g)
    for name, g in want_g.items():
        _rel(got_g[name].grad.numpy(), g.numpy(), MODULE_REL, f"d {name}")
