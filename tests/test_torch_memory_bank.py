"""The port's memory bank and Sinkhorn solver against the JAX package's.

``models/memory_bank.py`` (``init_bank``, the circular ``bank_append``
with its disabled no-op, ``retrieve_similar``, ``align_loss``) and
``core/sinkhorn.py`` (``sinkhorn``, ``semantic_correspondence``,
``_neighbor_shift_sum``, ``hough_matching``, the latter also against the
torch oracle of the reference's Hough voting that the JAX package's own
test uses), on the CPU, on the same seeded inputs. Modelled on
``tests/test_losses_bank.py`` and ``tests/test_misc_components.py``.

Tolerances: bank contents, masks and pointers exactly (copies and
integer logic); cosines, losses and Sinkhorn plans to 1e-5 (f32 sums in
another order; the plan goes through 50-100 logsumexp rounds); the Hough
correspondence to 1e-3 of its largest |C| (at least 1e-3, as the JAX
package's test holds its own against the oracle): near-zero row-sum
denominators amplify f32 order noise in proportion to |C|.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

TOL = 1e-5


def _sinkhorn_modules():
    """Both packages' ``core/sinkhorn.py`` (``core`` exports a function of
    the same name)."""
    import importlib

    return (importlib.import_module("attentionshift_torch.core.sinkhorn"),
            importlib.import_module("attentionshift_tpu.core.sinkhorn"))


def _bank_pair(seed: int = 0, c: int = 3, q: int = 4, p: int = 3, d: int = 8, n: int = 7):
    """Both packages' banks after the same ``n`` appends (one disabled, the
    queue wrapping around), and the appended objects."""
    from attentionshift_torch.models import memory_bank as tb
    from attentionshift_tpu.models import memory_bank as jb

    rs = np.random.RandomState(seed)
    objs = []
    for i in range(n):
        objs.append(dict(cls=int(rs.randint(c)) if i else 1, token=rs.randn(d).astype(np.float32),
                         parts=rs.randn(p, d).astype(np.float32), pv=rs.rand(p) > 0.3,
                         box=np.sort(rs.rand(4) * 50).astype(np.float32)[[0, 1, 2, 3]],
                         enable=i != 3))
        o = objs[-1]
        o["box"] = np.asarray([o["box"][0], o["box"][1], o["box"][0] + 5 + o["box"][2],
                               o["box"][1] + 5 + o["box"][3]], np.float32)
    jbank = jb.init_bank(c, q, p, d)
    tbank = tb.init_bank(c, q, p, d, device="cpu")
    for o in objs:
        jbank = jb.bank_append(jbank, jnp.asarray(o["cls"]), jnp.asarray(o["token"]),
                               jnp.asarray(o["parts"]), jnp.asarray(o["pv"]), jnp.asarray(o["box"]),
                               enable=o["enable"])
        tbank = tb.bank_append(tbank, torch.tensor(o["cls"]), torch.from_numpy(o["token"]),
                               torch.from_numpy(o["parts"]), torch.from_numpy(o["pv"]),
                               torch.from_numpy(o["box"]), enable=o["enable"])
    return jbank, tbank, objs


def test_bank_appends_match_jax():
    """Every field after seven appends (one disabled; class 1's queue
    wraps), bitwise, with the JAX dtypes."""
    jbank, tbank, _ = _bank_pair()
    for name in jbank._fields:
        want, got = np.asarray(getattr(jbank, name)), getattr(tbank, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_bank_wraps_around_and_disabled_append_is_a_noop():
    """The JAX package's own cases: a queue of 2 after 3 appends, and an
    append with ``enable=False``, which leaves its argument as it was."""
    from attentionshift_torch.models import memory_bank as tb

    bank = tb.init_bank(1, 2, 1, 4, device="cpu")
    for i in range(3):
        bank = tb.bank_append(bank, torch.tensor(0), torch.full((4,), float(i + 1)),
                              torch.full((1, 4), float(i + 1)), torch.ones((1,), dtype=torch.bool),
                              torch.tensor([0.0, 0.0, 1.0, 1.0]))
    assert int(bank.ptr[0]) == 1
    assert float(bank.tokens[0, 0, 0]) == 3.0 and float(bank.tokens[0, 1, 0]) == 2.0
    empty = tb.init_bank(1, 2, 1, 4, device="cpu")
    same = tb.bank_append(empty, torch.tensor(0), torch.ones(4), torch.ones((1, 4)),
                          torch.ones((1,), dtype=torch.bool), torch.zeros(4), enable=False)
    assert not bool(same.slot_valid.any()) and int(same.ptr[0]) == 0
    assert not bool(empty.tokens.any())


@pytest.mark.parametrize("thresh,ratio", [(0.7, (0.5, 2.0)), (-0.5, (0.2, 5.0)), (0.0, (0.9, 1.1))])
def test_retrieve_and_align_loss_match_jax(thresh, ratio):
    """Retrieval masks exactly and the align loss to 1e-5, for every class
    and every appended object as the query, under three gates."""
    from attentionshift_torch.models import memory_bank as tb
    from attentionshift_tpu.models import memory_bank as jb

    jbank, tbank, objs = _bank_pair(seed=1)
    rs = np.random.RandomState(7)
    queries = objs + [dict(cls=c, token=objs[0]["token"] + 0.1 * rs.randn(8).astype(np.float32),
                           parts=rs.randn(3, 8).astype(np.float32), pv=np.asarray([True, False, True]),
                           box=objs[0]["box"]) for c in range(3)]
    for o in queries:
        ja = (jnp.asarray(o["cls"]), jnp.asarray(o["token"]))
        ta = (torch.tensor(o["cls"]), torch.from_numpy(o["token"]))
        want = np.asarray(jb.retrieve_similar(jbank, *ja, jnp.asarray(o["box"]), thresh, ratio))
        got = tb.retrieve_similar(tbank, *ta, torch.from_numpy(o["box"]), thresh, ratio).numpy()
        np.testing.assert_array_equal(got, want)
        jl = float(jb.align_loss(jbank, *ja, jnp.asarray(o["parts"]), jnp.asarray(o["pv"]),
                                 jnp.asarray(o["box"]), thresh, ratio))
        tl = float(tb.align_loss(tbank, *ta, torch.from_numpy(o["parts"]),
                                 torch.from_numpy(o["pv"]), torch.from_numpy(o["box"]), thresh,
                                 ratio))
        assert abs(tl - jl) <= TOL * max(1.0, abs(jl)), (tl, jl)


def test_align_loss_identical_parts_and_empty_bank():
    """The JAX package's cases: parts retrieved from themselves give 0; an
    empty bank gives exactly 0."""
    from attentionshift_torch.models import memory_bank as tb

    parts = torch.from_numpy(np.random.RandomState(0).rand(2, 8).astype(np.float32))
    tok, box, pv = torch.ones(8), torch.tensor([0.0, 0.0, 10.0, 10.0]), torch.ones(2, dtype=torch.bool)
    bank = tb.bank_append(tb.init_bank(1, 2, 2, 8, device="cpu"), torch.tensor(0), tok, parts, pv,
                          box)
    assert abs(float(tb.align_loss(bank, torch.tensor(0), tok, parts, pv, box))) <= 1e-5
    empty = tb.init_bank(1, 2, 2, 8, device="cpu")
    assert float(tb.align_loss(empty, torch.tensor(0), tok, parts, pv, box)) == 0.0


@pytest.mark.parametrize("n,m,eps,iters,marginals", [(5, 7, 0.05, 100, False),
                                                     (6, 4, 0.1, 50, True), (3, 3, 0.01, 20, True)])
def test_sinkhorn_matches_jax(n, m, eps, iters, marginals):
    ts, js = _sinkhorn_modules()

    rs = np.random.RandomState(n * m)
    cost = rs.rand(n, m).astype(np.float32)
    mu = nu = None
    if marginals:
        mu, nu = (x / x.sum() for x in (rs.rand(n).astype(np.float32),
                                        rs.rand(m).astype(np.float32)))
    want = np.asarray(js.sinkhorn(jnp.asarray(cost), None if mu is None else jnp.asarray(mu),
                                  None if nu is None else jnp.asarray(nu), eps, iters))
    got = ts.sinkhorn(torch.from_numpy(cost), None if mu is None else torch.from_numpy(mu),
                      None if nu is None else torch.from_numpy(nu), eps, iters).numpy()
    np.testing.assert_allclose(got, want, atol=TOL * max(want.max(), 1e-30), rtol=0)
    if not marginals:  # the JAX package's marginal check
        np.testing.assert_allclose(got.sum(1), 1.0 / n, atol=1e-3)
        np.testing.assert_allclose(got.sum(0), 1.0 / m, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_semantic_correspondence_matches_jax(masked):
    """Plan to 1e-5 and matches exactly, with and without validity masks;
    identity features match themselves, as in the JAX package's test."""
    ts, js = _sinkhorn_modules()

    rs = np.random.RandomState(3)
    a, b = rs.randn(6, 16).astype(np.float32), rs.randn(5, 16).astype(np.float32)
    va, vb = (np.asarray([1, 1, 0, 1, 1, 1], bool), np.asarray([1, 0, 1, 1, 1], bool)) \
        if masked else (None, None)
    jplan, jmatch = js.semantic_correspondence(
        jnp.asarray(a), jnp.asarray(b), None if va is None else jnp.asarray(va),
        None if vb is None else jnp.asarray(vb))
    plan, match = ts.semantic_correspondence(
        torch.from_numpy(a), torch.from_numpy(b), None if va is None else torch.from_numpy(va),
        None if vb is None else torch.from_numpy(vb))
    jplan = np.asarray(jplan)
    np.testing.assert_allclose(plan.numpy(), jplan, atol=TOL * jplan.max(), rtol=0)
    np.testing.assert_array_equal(match.numpy(), np.asarray(jmatch))
    assert match.dtype == torch.int32
    eye = torch.eye(4, 8)
    np.testing.assert_array_equal(ts.semantic_correspondence(eye, eye, epsilon=0.01)[1].numpy(),
                                  np.arange(4))


def test_neighbor_shift_sum_matches_jax():
    ts, js = _sinkhorn_modules()

    t = np.random.RandomState(4).randn(3, 5, 4, 6).astype(np.float32)
    want = np.asarray(js._neighbor_shift_sum(jnp.asarray(t)))
    np.testing.assert_allclose(ts._neighbor_shift_sum(torch.from_numpy(t)).numpy(), want,
                               atol=TOL * np.abs(want).max(), rtol=0)


def _hough_oracle(f0, f1, num_iter, num_smooth_iter, dist_kernel):
    """The torch oracle of the reference's regularised Hough voting that
    ``tests/test_misc_components.py`` holds the JAX package to: the
    max-pooled-identity distance mask, the joint-3x3 ``pass_message``
    average with border counts, per-row normalisation and the ``C =
    rownorm(Cu + votes)`` outer loop."""
    import torch.nn.functional as F

    h, w, d = f0.shape
    n = h * w
    a = torch.from_numpy(f0.reshape(n, d))
    b = torch.from_numpy(f1.reshape(n, d))
    a = a / (a.norm(dim=1, keepdim=True) + 1e-4)
    b = b / (b.norm(dim=1, keepdim=True) + 1e-4)
    cu = (a @ b.t()).unsqueeze(0)
    eye = torch.eye(n).reshape(1, -1, h, w)
    dist_mask = F.max_pool2d(eye, kernel_size=dist_kernel, stride=1,
                             padding=dist_kernel // 2).reshape(1, n, n).transpose(2, 1)

    def pass_message(t):
        t = t.view(1, h, w, h, w)
        pair = torch.zeros_like(t)
        count = torch.zeros_like(t)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ys, xs = max(0, dy), max(0, dx)
                ye, xe = min(h + dy, h), min(w + dx, w)
                count[:, ys:ye, xs:xe, ys:ye, xs:xe] += 1
                pair[:, ys:ye, xs:xe, ys:ye, xs:xe] += t[
                    :, max(0, -dy):min(h - dy, h), max(0, -dx):min(w - dx, w),
                    max(0, -dy):min(h - dy, h), max(0, -dx):min(w - dx, w)]
        return (pair / count).view(1, n, n)

    c = cu.clone() * dist_mask
    for _ in range(num_iter):
        votes = c.clone()
        for _ in range(num_smooth_iter):
            votes = pass_message(votes)
            votes = votes / (votes.sum(2, keepdim=True) + 1e-4)
        c = cu + votes
        c = c / (c.sum(2, keepdim=True) + 1e-4)
    return cu[0].numpy(), c[0].numpy()


@pytest.mark.parametrize("h,w,num_iter,num_smooth_iter,dist_kernel",
                         [(5, 5, 2, 3, 3), (4, 6, 1, 3, 5), (3, 4, 2, 1, 1)])
def test_hough_matching_matches_jax_and_the_torch_oracle(h, w, num_iter, num_smooth_iter,
                                                          dist_kernel):
    ts, js = _sinkhorn_modules()

    rs = np.random.RandomState(0)
    f0 = rs.randn(h, w, 16).astype(np.float32)
    f1 = rs.randn(h, w, 16).astype(np.float32)
    kw = dict(num_iter=num_iter, num_smooth_iter=num_smooth_iter, dist_kernel=dist_kernel)
    jcu, jc = (np.asarray(x) for x in js.hough_matching(jnp.asarray(f0), jnp.asarray(f1), **kw))
    cu, c = (x.numpy() for x in ts.hough_matching(torch.from_numpy(f0), torch.from_numpy(f1),
                                                   **kw))
    ocu, oc = _hough_oracle(f0, f1, num_iter, num_smooth_iter, dist_kernel)
    np.testing.assert_allclose(cu, jcu, atol=TOL, rtol=0)
    np.testing.assert_allclose(cu, ocu, atol=TOL, rtol=0)
    # C divides by row sums of signed values + 1e-4, which come near 0, and
    # |C| grows as they do: f32 order noise scales with the largest |C|
    # (at (4, 6, 1, 3, 5) |C| reaches 179, and the port's f32 result is
    # 0.09 from an f64 evaluation of the same code). 1e-3 of it, at least 1e-3.
    tol = 1e-3 * max(1.0, float(np.abs(jc).max()))
    np.testing.assert_allclose(c, jc, atol=tol, rtol=0)
    np.testing.assert_allclose(c, oc, atol=tol, rtol=0)
