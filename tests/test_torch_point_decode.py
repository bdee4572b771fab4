"""The port's point-token decoding and CRF against the JAX package's, on the CPU.

``pseudo/cam.py``'s ``bbox_from_cam`` and ``bbox_from_labels`` (and the
batch function on the same planes), ``pseudo/point2bbox.py`` and
``pseudo/crf.py`` (``feature_affinity``, ``mean_field_refine``,
``water_fill``). Inputs are made from numpy seeds and go through both
packages.

Tolerances: component labels, thresholded planes, valid flags, labels
and water-fill prototypes exactly (integer logic and copies); boxes to
1e-4 px (they are integer grid extents, mirrored and scaled, so equal in
practice); scores to 1e-6 relative (one sigmoid); affinities and refined
maps to 1e-5 of the largest entry (f32 sums in another order; the maps
lie in [0, 1]). ``point2bbox`` runs at ``ccl_iters=64``, at which every
plane of these inputs converges (asserted through the plain CCL's sweep
counts), so its labels are a fixpoint that any sweep order reaches.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from test_torch_support import close  # noqa: E402

BOX_TOL = 1e-4
MAP_REL = 1e-5


def _smooth_cams(n, h, w, seed):
    """(n, h, w) f32 maps: blurred noise, a few blobs each."""
    from scipy import ndimage

    rs = np.random.RandomState(seed)
    return np.stack([ndimage.gaussian_filter(rs.rand(h, w), 1.5) for _ in range(n)]).astype(
        np.float32)


def _labels(planes):
    from attentionshift_torch.ops.ccl import connected_components

    return connected_components(torch.from_numpy(planes), 256)


@pytest.mark.parametrize("seed", [0, 1])
def test_bbox_from_labels_matches_jax(seed):
    """Single-plane and batch functions against the JAX per-plane one: blob
    planes, an empty plane (the [0, 0, 1, 1] fallback), points at the
    corners and mid-plane, area ratios 0.5 and 0.0."""
    from attentionshift_torch.pseudo import cam as tc
    from attentionshift_tpu.pseudo import cam as jc

    h, w = 20, 28
    planes = _smooth_cams(5, h, w, seed) > 0.5
    planes[-1] = False
    labels = _labels(planes)
    rs = np.random.RandomState(seed + 10)
    pts = np.concatenate([[[0.0, 0.0], [w - 0.5, h - 0.5]], rs.rand(3, 2) * [w, h]]).astype(
        np.float32)
    for ratio in (0.5, 0.0):
        batch = tc.bbox_from_labels_batch(labels, torch.from_numpy(pts), ratio).numpy()
        for i in range(len(planes)):
            want = np.asarray(jc.bbox_from_labels(jnp.asarray(labels[i].numpy()),
                                                  jnp.asarray(pts[i]), ratio))
            got = tc.bbox_from_labels(labels[i], torch.from_numpy(pts[i]), ratio).numpy()
            close(got, want, BOX_TOL, what=f"plane {i} ratio {ratio}")
            close(batch[i], want, BOX_TOL, what=f"batch plane {i} ratio {ratio}")
    assert tc.bbox_from_labels(labels[-1], torch.zeros(2)).tolist() == [0.0, 0.0, 1.0, 1.0]


@pytest.mark.parametrize("thr", [0.2, 0.5])
def test_bbox_from_cam_matches_jax(thr):
    from attentionshift_torch.pseudo.cam import bbox_from_cam
    from attentionshift_tpu.pseudo.cam import bbox_from_cam as jbbox

    cams = _smooth_cams(4, 24, 30, 3) * 5.0 - 1.0
    pts = (np.random.RandomState(4).rand(4, 2) * [30, 24]).astype(np.float32)
    for i in range(4):
        want = np.asarray(jbbox(jnp.asarray(cams[i]), jnp.asarray(pts[i]), cam_thr=thr,
                                ccl_iters=64))
        got = bbox_from_cam(torch.from_numpy(cams[i]), torch.from_numpy(pts[i]), cam_thr=thr,
                            ccl_iters=64).numpy()
        close(got, want, BOX_TOL, what=f"map {i}")


def _decode_inputs(p, c, hp, wp, seed, extra_tokens=0):
    """Logits, coords in [0, 1] and rollout rows (cls | patches | pad |
    points columns) whose patch block holds 1-3 Gaussian bumps per token
    over weak noise: components of a few cells, some of them split."""
    rs = np.random.RandomState(seed)
    cls = (rs.randn(p, c) * 3).astype(np.float32)
    reg = rs.rand(p, 2).astype(np.float32)
    t = 1 + hp * wp + extra_tokens + p
    rows = np.abs(rs.rand(p, t)).astype(np.float32) * 0.01
    yy, xx = np.mgrid[:hp, :wp]
    for i in range(p):
        cam = 0.05 * rs.rand(hp, wp)
        for _ in range(rs.randint(1, 4)):
            cy, cx, s = rs.rand() * hp, rs.rand() * wp, 0.6 + rs.rand()
            cam += rs.rand() * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        rows[i, 1:1 + hp * wp] = cam.reshape(-1)
    return cls, reg, rows


@pytest.mark.parametrize("p,c,hp,wp,stride,wh,extra", [
    (6, 5, 8, 8, 8, (128.0, 128.0), 0),
    (12, 20, 10, 14, 8, (220.0, 150.0), 5),
    (8, 3, 6, 10, 16, (150.0, 90.0), 0),
])
def test_point2bbox_matches_jax(p, c, hp, wp, stride, wh, extra):
    """The whole decoding: boxes, scores, labels, valid flags; the planes
    the port labels against JAX's resize + normalisation + threshold,
    exactly; every plane converged within ``ccl_iters``."""
    from attentionshift_torch.ops.ccl import connected_components
    from attentionshift_torch.pseudo.point2bbox import point2bbox, point_planes
    from attentionshift_tpu.ops.image import resize
    from attentionshift_tpu.pseudo.cam import normalize_cam
    from attentionshift_tpu.pseudo.point2bbox import point2bbox as jpoint2bbox

    cls, reg, rows = _decode_inputs(p, c, hp, wp, seed=p, extra_tokens=extra)
    kw = dict(seed_score_thr=0.9, cam_stride=stride, ccl_iters=64)
    want = jpoint2bbox(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(rows), (hp, wp),
                       jnp.asarray(wh), **kw)
    got = point2bbox(torch.from_numpy(cls), torch.from_numpy(reg), torch.from_numpy(rows),
                     (hp, wp), torch.tensor(wh), **kw)
    planes = point_planes(torch.from_numpy(rows), (hp, wp), 0.2, stride)
    cams = resize(jnp.asarray(rows[:, 1:1 + hp * wp].reshape(p, hp, wp)),
                  (hp * 16 // stride, wp * 16 // stride))
    jplanes = np.stack([np.asarray(normalize_cam(m)) >= 0.2 for m in cams])
    np.testing.assert_array_equal(planes.numpy(), jplanes)
    _, sweeps = connected_components(planes, 64, return_sweeps=True)
    assert int(sweeps.max()) < 64, "a plane reached the sweep cap"
    close(got.boxes.numpy(), np.asarray(want.boxes), BOX_TOL, what="boxes")
    close(got.scores.numpy(), np.asarray(want.scores), 0.0, rtol=1e-6, what="scores")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.labels.dtype == torch.int32 and got.valid.dtype == torch.bool
    assert 0 < int(got.valid.sum()) < p  # the score floor splits the tokens


def _cluster_feats(h, w, d, seed):
    rs = np.random.RandomState(seed)
    feats = np.ones((h * w, d), np.float32) * 0.1
    feats[: h * w // 2, 0] = 1.0
    feats[h * w // 2:, 1] = 1.0
    return (feats + rs.randn(h * w, d) * 0.05).astype(np.float32)


@pytest.mark.parametrize("sim_bin_thr", [0.0, 0.3])
def test_feature_affinity_matches_jax(sim_bin_thr):
    from attentionshift_torch.pseudo.crf import feature_affinity
    from attentionshift_tpu.pseudo.crf import feature_affinity as jaff

    feats = np.random.RandomState(0).randn(6 * 7, 5).astype(np.float32)
    want = np.asarray(jaff(jnp.asarray(feats), (6, 7), 0.5, sim_bin_thr))
    got = feature_affinity(torch.from_numpy(feats), (6, 7), 0.5, sim_bin_thr).numpy()
    close(got, want, MAP_REL * np.abs(want).max())
    assert (np.diag(got) == 0).all() and (got >= 0).all()


@pytest.mark.parametrize("g,num_iter,pairwise", [(1, 10, 1.0), (3, 10, 1.0), (4, 5, 0.5)])
def test_mean_field_refine_matches_jax(g, num_iter, pairwise):
    from attentionshift_torch.pseudo.crf import mean_field_refine
    from attentionshift_tpu.pseudo.crf import mean_field_refine as jmf

    h, w = 8, 10
    feats = _cluster_feats(h, w, 8, g)
    maps = np.random.RandomState(g + 1).rand(g, h, w).astype(np.float32)
    maps[0, : h // 2] += 0.5
    maps = np.clip(maps, 0.0, 1.0)
    want = np.asarray(jmf(jnp.asarray(maps), jnp.asarray(feats), num_iter=num_iter,
                          pairwise_weight=pairwise))
    got = mean_field_refine(torch.from_numpy(maps), torch.from_numpy(feats), num_iter=num_iter,
                            pairwise_weight=pairwise).numpy()
    close(got, want, MAP_REL * np.abs(want).max())


def test_mean_field_refine_sharpens():
    """The JAX test's clustered case: the refined map separates the two
    feature clusters harder than the unary did."""
    from attentionshift_torch.pseudo.crf import mean_field_refine

    h = w = 8
    attn = np.zeros((1, h, w), np.float32)
    attn[0, : h // 2] = 0.55
    attn[0, h // 2:] = 0.45
    out = mean_field_refine(torch.from_numpy(attn), torch.from_numpy(_cluster_feats(h, w, 8, 0)),
                            num_iter=10).numpy()
    assert out[0, : h // 2].mean() > 0.6 and out[0, h // 2:].mean() < 0.4


@pytest.mark.parametrize("thr,n_iter,seed", [(None, 4, 0), (0.55, 4, 0), (0.55, 8, 1),
                                             (0.9, 6, 2)])
def test_water_fill_matches_jax(thr, n_iter, seed):
    """Prototypes and validity flags exactly, with slots that run out of
    mass (invalid, and every later slot with them) among the cases."""
    from attentionshift_torch.pseudo.crf import water_fill
    from attentionshift_tpu.pseudo.crf import water_fill as jwf

    rs = np.random.RandomState(seed)
    n, d = 24, 6
    feats = rs.randn(n, d).astype(np.float32)
    sim = (rs.rand(n, n) * 0.6 + 0.2).astype(np.float32)
    np.fill_diagonal(sim, 1.0)
    attn = (rs.rand(n) > 0.5).astype(np.float32)
    wp, wv = jwf(jnp.asarray(feats), jnp.asarray(sim), jnp.asarray(attn), n_iter=n_iter, thr=thr)
    gp, gv = water_fill(torch.from_numpy(feats), torch.from_numpy(sim), torch.from_numpy(attn),
                        n_iter=n_iter, thr=thr)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if seed == 1:
        assert not bool(gv.all()), "the case with slots beyond the mass lost them"
