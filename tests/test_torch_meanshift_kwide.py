"""The mean-shift kernel's second route (K above 32), on the CPU.

``csrc/meanshift.cu`` runs it as four kernels per iteration (with bf16
operands ``kwt_sim``, ``kwt_lse``, ``kwt_assign``, ``kwt_update``; with
f32 operands ``kw_sim`` and ``kw_update`` in place of the first and the
last) whose grids, tiles per block, shared memory and scratch the host
picks (``kwt_plan``); ``ops/meanshift_kernel.py::kwide_plan`` mirrors
that plan.
The kernels run only on the card (``tests/test_torch_gpu.py`` and
``chip_smoke.py``, which also hold the library's plan against this mirror
at every (K, N, D) below). Here: the blocks of each kernel, mirrored from
their index arithmetic, cover every (instance, chunk, feature tile) and
every (instance, chunk, 64-dim box) exactly once; the host's choice of
tiles per block against brute force; shared memory fits; scratch as its parts count it; the
arithmetic of ``kwt_lse`` (the bandwidth from the per-tile density partials
of ``kwt_sim``, then the log-sum-exp) mirrored in f32 and held to the plain
version and to ``torch.logsumexp``; ``kwt_lse``'s division-free quotient
against the rounded division; and the plain version against the Pallas
kernel in interpret mode above the cluster kernel's 32 prototypes.
"""

from __future__ import annotations

from fractions import Fraction
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from attentionshift_torch.ops import meanshift_kernel as mk  # noqa: E402

SMS = 132  # an H100 SXM
SMEM_LIMIT = 227 * 1024  # a block's dynamic shared memory on Hopper
SM_SMEM = 233472  # an SM's, each block also reserving 1 KB


def per_sm(kernel, smem):
    """Blocks per SM by shared memory alone (the card's occupancy also
    counts registers; chip_smoke.py prints the library's)."""
    return min(2, SM_SMEM // (smem + 1024))


KS = (33, 64, 65, 256, 257, 512, 1000)
NS = (1, 63, 64, 4200)
DS = (16, 200, 384, 768, 1024)


def padded(d):
    """D as the bf16 kernels take it: zero-padded to a multiple of 16."""
    return -(-d // 16) * 16


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_kwide_sim_plan_covers_every_unit_once(k, n):
    """kwt_sim's block (x, y, z) takes instance z, prototypes [64 y, 64 y +
    64) and the tiles [x tpb, min(NT, x tpb + tpb)) in rounds of W =
    ``KWIDE_SIM_WARPGROUPS`` (its warpgroup w the round's tile w while below
    the block's end): every (instance, chunk, tile) once, the chunks every
    prototype once; shared memory within a block's limit."""
    g, w = 3, mk.KWIDE_SIM_WARPGROUPS
    for d in DS:
        plan = mk.kwide_plan(g, k, n, padded(d), SMS, per_sm)
        tpb = plan["tiles_per_block"]
        assert plan["tiles"] == -(-n // 64) and plan["dims"] == -(-padded(d) // 64)
        assert tpb % w == 0 and plan["sim_blocks"] * tpb >= plan["tiles"]
        units = {}
        for z in range(g):
            for y in range(plan["chunks"]):
                for x in range(plan["sim_blocks"]):
                    t0, t1 = x * tpb, min(plan["tiles"], x * tpb + tpb)
                    for r in range(-(-(t1 - t0) // w)):
                        for v in range(w):
                            tile = t0 + w * r + v
                            if tile < t1:
                                units.setdefault((z, y, tile), []).append((x, v))
        want = {(z, y, t) for z in range(g) for y in range(plan["chunks"])
                for t in range(plan["tiles"])}
        assert set(units) == want and all(len(v) == 1 for v in units.values())
        kc = mk.KWIDE_CHUNK
        cols = [y * kc + c for y in range(plan["chunks"]) for c in range(kc) if y * kc + c < k]
        assert cols == list(range(k)) and (plan["chunks"] - 1) * kc < k
        assert plan["sim_smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k", KS)
def test_kwide_update_plan_covers_every_unit_once(k, n):
    """kwt_update's block (x, y, z) takes the 64-dim box x of chunk y of
    instance z over every tile, its warpgroup w the tiles w, w + W, ... (W =
    ``KWIDE_UPDATE_WARPGROUPS``) in an even count of steps of W tiles (the
    steps past the tiles multiply zeros): every (instance, chunk, box) once,
    each of its tiles once; the other warpgroups' partial sums (64 x 64 f32
    each) fit where its ring was; shared memory within a block's limit."""
    g, w = 3, mk.KWIDE_UPDATE_WARPGROUPS
    for d in DS:
        plan = mk.kwide_plan(g, k, n, padded(d), SMS, per_sm)
        steps = (-(-plan["tiles"] // w) + 1) // 2 * 2
        seen = sorted(w * s + v for s in range(steps) for v in range(w)
                      if w * s + v < plan["tiles"])
        assert seen == list(range(plan["tiles"])) and steps % 2 == 0
        boxes = {}
        for z in range(g):
            for y in range(plan["chunks"]):
                for x in range(plan["dims"]):
                    boxes[(z, y, x)] = boxes.get((z, y, x), 0) + 1
        assert len(boxes) == g * plan["chunks"] * plan["dims"] and set(boxes.values()) == {1}
        assert (w - 1) * 64 * mk.KWIDE_CHUNK * 4 <= mk.KWIDE_UPDATE_STAGES * w * 8192
        assert plan["update_smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("k,n,sms,per", [(64, 4200, 132, 2), (256, 4200, 132, 1),
                                         (257, 4200, 132, 2), (33, 46000, 132, 2),
                                         (512, 63, 132, 1), (100, 4200, 16, 1)])
def test_kwide_tiles_per_block_fewest_waves_of_rounds(k, n, sms, per):
    """kwt_sim's tiles per block: of the multiples of its warpgroups (2),
    the one whose waves (blocks over the blocks the card holds at once)
    times rounds of two tiles are fewest, the larger count on a tie; at the
    bench shape (G 20, N 4200) with two blocks per SM that is 6 (220 blocks
    in one wave of 264 at K = 64), with one 2 (2640 blocks in 20 waves of
    132 at K = 256: four chunks)."""
    g = 20
    plan = mk.kwide_plan(g, k, n, 384, sms, lambda kernel, smem: per)
    nt = -(-n // 64)
    costs = {t: -(-(g * plan["chunks"] * -(-nt // t)) // (sms * per)) * ((min(t, nt) + 1) // 2)
             for t in range(2, nt + 2, 2)}
    best = min(costs.values())
    assert plan["tiles_per_block"] == max(t for t, c in costs.items() if c == best)
    if (k, n, sms, per) == (64, 4200, 132, 2):
        assert plan["tiles_per_block"] == 6 and plan["sim_blocks"] * g == 220
    if (k, n, sms, per) == (256, 4200, 132, 1):
        assert plan["tiles_per_block"] == 2 and plan["sim_blocks"] * g * plan["chunks"] == 2640


@pytest.mark.parametrize("k", KS)
def test_kwide_scratch_counts_its_parts(k):
    """The bf16 route's scratch in f32 floats, each part rounded up to 4
    (16 bytes): the prototypes' bf16 copy (2 bytes each), squared norms per
    64-dim box, (sum, count) per 64-feature tile, the log-sum-exp per
    prototype, weights and int32 assignments per feature;
    the f32 route's the same parts but the bf16 copy, at any D. The scratch
    the plan reports is this count."""
    g = 20
    for n in NS:
        for d in DS:
            dk = padded(d)
            parts = [g * k * dk * 2 // 4, g * k * -(-dk // 64), 2 * g * k * -(-n // 64), g * k,
                     g * n, g * n]
            want = sum(-(-x // 4) * 4 for x in parts)
            assert mk.kwide_work_floats(g, k, n, dk, True) == want
            assert mk.kwide_plan(g, k, n, dk, SMS, per_sm)["work_floats"] == want
            f32 = [g * k * -(-d // 64), 2 * g * k * -(-n // 64), g * k, g * n, g * n]
            assert mk.kwide_work_floats(g, k, n, d, False) == sum(-(-x // 4) * 4 for x in f32)


def _block_sum(v, threads=256):
    """kwt_lse's sum of per-element f32 values v (K, N): thread i of
    ``threads`` adds n = i, i + threads, ... in order; each warp of 32 by
    a butterfly (x += shfl_xor(x, off), off = 16 ... 1); the warps in order."""
    k, n = v.shape
    f32 = np.float32
    acc = np.zeros((k, threads), f32)
    for j in range(0, n, threads):
        cols = min(threads, n - j)
        acc[:, :cols] = (acc[:, :cols] + v[:, j:j + cols]).astype(f32)
    acc = acc.reshape(k, threads // 32, 32)
    off = 16
    while off:
        acc = (acc + acc[..., np.arange(32) ^ off]).astype(f32)
        off //= 2
    total = acc[:, 0, 0]
    for w in range(1, threads // 32):
        total = (total + acc[:, w, 0]).astype(f32)
    return total


def kwt_lse_mirror(c, idx, first, tau0=0.1, temp=0.1):
    """kwt_sim's density partials and kwt_lse's arithmetic in f32 for one
    instance: c (K, N) the masked similarities to the current prototypes,
    idx (N,) the previous assignment. Per (prototype, 64-feature tile) the
    sum of c over the tile's features assigned to it, in row order, and
    their count; the bandwidth from those partials (lane l of a warp takes
    tiles l, l + 32, ... in order, the 32 lanes by a butterfly), tau0 at the
    first iteration; then the max of c, its quotient by temp * tau, and the
    sum of exp(c / (temp tau) - max) in the block's order (``_block_sum``).
    Returns tau, lse (K,) f32."""
    k, n = c.shape
    nt = -(-n // 64)
    f32 = np.float32
    tau = np.full(k, tau0, f32)
    if not first:
        part = np.zeros((k, nt, 2), f32)
        for t in range(nt):
            for r in range(t * 64, min(n, t * 64 + 64)):
                part[idx[r], t, 0] = f32(part[idx[r], t, 0] + c[idx[r], r])
                part[idx[r], t, 1] += f32(1)
        lanes = np.zeros((k, 32, 2), f32)
        for lane in range(32):
            for t in range(lane, nt, 32):
                lanes[:, lane] = (lanes[:, lane] + part[:, t]).astype(f32)
        off = 16
        while off:  # warp_sum: x += shfl_xor(x, off)
            lanes = (lanes + lanes[:, np.arange(32) ^ off]).astype(f32)
            off //= 2
        s, cnt = lanes[:, 0, 0], lanes[:, 0, 1]
        mean = np.where(cnt >= 1, s / np.maximum(cnt, f32(1)), f32(0)).astype(f32)
        tau = np.maximum(f32(1) - mean, f32(1e-10)).astype(f32)
    tt = (f32(temp) * tau).astype(f32)
    mx = (c.max(axis=1) / tt).astype(f32)
    terms = np.exp((c / tt[:, None]).astype(f32) - mx[:, None]).astype(f32)
    return tau, (np.log(_block_sum(terms)) + mx).astype(f32)


def _plain_tau_and_lse(c, idx, first, tau0=0.1, temp=0.1):
    """The plain version's bandwidth (``cosine_shift_batch``: the mean of
    the similarities to the new prototypes over each prototype's assigned
    features, 1 where none) and log-sum-exp, in f64."""
    c64 = torch.from_numpy(c).double()
    k, n = c.shape
    if first:
        tau = torch.full((k,), tau0, dtype=torch.float64)
    else:
        mask_w = (torch.arange(k)[:, None] == torch.from_numpy(idx)[None]).double()
        cnt, dens = mask_w.sum(-1), (c64 * mask_w).sum(-1)
        tau = (1.0 - torch.where(cnt >= 1, dens / cnt.clamp_min(1.0), torch.zeros_like(dens))
               ).clamp_min(1e-10)
    return tau, torch.logsumexp(c64 / (temp * tau[:, None]), dim=-1)


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("case", ["random", "all masked", "features masked to 0",
                                  "a prototype without features"])
def test_kwide_lse_mirror_holds_to_the_plain_version(case, first):
    """The mirror of kwt_sim's density partials and kwt_lse against the
    plain version's bandwidth and ``torch.logsumexp`` of c / (temp tau), in
    f64: tau within 1e-6 and lse within 2e-6 relative (f32 sums of 4200
    terms of at most 1, in another order). An all-masked instance (c all
    0: tau 1, lse log N + 0), features masked to 0 (their c is 0 and they
    still count), a prototype no feature is assigned to (tau 1). Control:
    the density partials of every second tile dropped moves tau."""
    rs = np.random.RandomState(25)
    k, n = 40, 4200
    c = np.clip(rs.randn(k, n) * 0.2 + 0.6, -1, 1).astype(np.float32)
    idx = rs.randint(0, k, n)
    if case == "all masked":
        c[:] = 0.0
    elif case == "features masked to 0":
        c[:, rs.rand(n) > 0.5] = 0.0
    elif case == "a prototype without features":
        idx[idx == 7] = 8
    tau, lse = kwt_lse_mirror(c, idx, first)
    want_tau, want_lse = _plain_tau_and_lse(c, idx, first)
    np.testing.assert_allclose(tau, want_tau.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse, want_lse.numpy(), rtol=2e-6)
    if case == "all masked":
        assert np.allclose(lse, np.log(n), rtol=1e-6) and (first or np.all(tau == 1.0))
    if case == "a prototype without features" and not first:
        assert tau[7] == 1.0
    if not first and case != "all masked":
        keep = np.array([(r // 64) % 2 == 0 for r in range(n)])
        ctl_tau, _ = kwt_lse_mirror(np.where(keep[None], c, 0.0).astype(np.float32), idx, first)
        assert np.abs(ctl_tau - want_tau.numpy()).max() > 1e-3


def _rn32(x):
    """The exact rational x rounded to the nearest float32, ties to even
    (normal range)."""
    if x == 0:
        return np.float32(0.0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    m = x / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    n = m.numerator // m.denominator
    if m - n > Fraction(1, 2) or (m - n == Fraction(1, 2) and n % 2 == 1):
        n += 1
    return np.float32(sign * n * 2.0 ** (e - 23))


def _kwt_lse_quotient(c, tt):
    """kwt_lse's c / tt without a division: rc = 1 / tt and q = c rc, each
    rounded (f32 operations), then the two fmas, each rounded once:
    RN(q + RN(c - q tt) rc)."""
    rc = np.float32(1.0) / tt
    q = c * rc
    r = _rn32(Fraction(float(c)) - Fraction(float(q)) * Fraction(float(tt)))
    return _rn32(Fraction(float(q)) + Fraction(float(r)) * Fraction(float(rc))), q


@pytest.mark.parametrize("seed", range(4))
def test_kwide_lse_quotient_is_the_rounded_division(seed):
    """kwt_lse divides each c (a cosine, in [-1, 1]) by the row's temp *
    tau through the correctly rounded reciprocal and one fma correction
    (Markstein's theorem): the result is the correctly rounded quotient, so
    the route's results are bitwise those of a division. 1500 random pairs
    per seed, c down to 1e-8 in size, temp * tau from 1e-11 (the bandwidth's
    floor 1e-10 times temp 0.1) to 10, and the edges. Control: the first
    product alone misses the rounded quotient for some pairs."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    c = (rs.uniform(-1, 1, 1500) * 10.0 ** rs.uniform(-8, 0, 1500)).astype(f32)
    tt = (10.0 ** rs.uniform(-11, 1, 1500)).astype(f32)
    c = np.concatenate([c, f32([1, -1, 0, 1, -1, 0.5, 1e-8])])
    tt = np.concatenate([tt, f32([0.1, 0.1, 0.1, 1e-11, 1e-11, 3.0, 7.0])])
    misses = 0
    for a, b in zip(c, tt):
        got, q = _kwt_lse_quotient(a, b)
        assert got == a / b, (a, b, got, a / b)
        misses += q != a / b
    assert misses > 0


def _interpret_pallas():
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    return mock.patch.object(pl, "pallas_call", interp)


@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k,n", [(129, 70), (257, 37)])
def test_kwide_plain_matches_pallas_kernel(k, n, matmul_dtype):
    """The plain version (what the wrapper runs for CPU tensors, and what
    the card's second route is held to) against ``_kernel``
    (attentionshift_tpu/ops/meanshift_kernel.py:47) in interpret mode, at K
    = 129 and 257 (a last chunk of one prototype on the card), with a fully
    masked instance, N ragged against the 64-feature tiles. f32: 1e-5
    (summation order); bf16 dot operands: the same rounding on both sides,
    1e-4."""
    from attentionshift_tpu.ops.meanshift_kernel import cosine_shift_fixpoint

    rs = np.random.RandomState(k + n)
    g, d = 3, 24
    f = rs.randn(n, d).astype(np.float32)
    mask = (rs.rand(g, n) > 0.4).astype(np.float32)
    mask[1] = 0.0
    prot0 = rs.randn(g, k, d).astype(np.float32)
    jdt = None if matmul_dtype is None else jnp.bfloat16
    tdt = None if matmul_dtype is None else torch.bfloat16
    with _interpret_pallas():
        want_p, want_s = cosine_shift_fixpoint(jnp.asarray(prot0), jnp.asarray(mask),
                                               jnp.asarray(f), n_shift=4, matmul_dtype=jdt,
                                               interpret=True)
    got_p, got_s = mk.cosine_shift_fixpoint(*map(torch.from_numpy, (prot0, mask, f)), n_shift=4,
                                            matmul_dtype=tdt)
    tol = 1e-5 if matmul_dtype is None else 1e-4
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=tol, atol=tol)
