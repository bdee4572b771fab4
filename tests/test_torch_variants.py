"""The port's attention variants and its microbenchmark tool against the
JAX package's ``tools/analysis/microbench_attention.py``.

The five TPU kernels (v2 ... v6) are closures inside the JAX tool's
``main()``. They run here as they are: the tool is loaded from its file,
``pallas_call`` is patched to interpret mode with a wrapper that records
each call's ``(out, mean)``, the tool's timer is patched to call the
variant once, and its seeded inputs are replaced by arrays made here, so
that both packages see the same bf16 values. On the CPU the port's
wrapper takes each variant's plain PyTorch version; the CUDA kernels are
held against those plain versions on the card (``test_torch_gpu``).
"""

from __future__ import annotations

import ctypes
import importlib.util
import math
import os
import re
import sys
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from attentionshift_torch.ops import attention, attention_variants  # noqa: E402
from attentionshift_torch.tools.analysis import microbench_attention as tool  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = list(attention_variants.VARIANTS)


def _bf16_inputs(b, h, t, d, seed=0):
    """q, k, v as f32 numpy arrays whose values are exact in bf16."""
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(b, h, t, d).astype(np.float32)).bfloat16().float().numpy()
            for _ in range(3)]


def _load_jax_tool():
    """The JAX tool as a module. Importing it points JAX's compilation
    cache at the repository's ``.jax_cache``; the setting is put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    path = os.path.join(REPO, "tools", "analysis", "microbench_attention.py")
    spec = importlib.util.spec_from_file_location("jax_microbench_attention", path)
    mod = importlib.util.module_from_spec(spec)
    old_path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = old_path
        for k, val in before.items():
            jax.config.update(k, val)
    return mod


def run_jax_variant(name, q, k, v):
    """(out, mean) of one TPU kernel of the JAX tool in interpret mode on
    the given (1, H, T, d) inputs (the tool's ``--dim d``)."""
    import jax.experimental.pallas as pl

    mod = _load_jax_tool()
    orig = pl.pallas_call
    calls = []

    def interp(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        fn = orig(*a, **kw)

        def run(*args):
            res = fn(*args)
            calls.append(res)
            return res

        return run

    class FixedInputs:
        def __init__(self, seed):
            self.arrays = [q, k, v]

        def randn(self, *shape):
            arr = self.arrays.pop(0)
            assert arr.shape == shape
            return arr

    def once(single, args, inner=32, iters=12):
        single(*args)
        return 0.0

    b, h, t, d = q.shape
    argv = ["microbench_attention.py", "--t", str(t), "--heads", str(h), "--dim", str(d),
            "--variants", name]
    with mock.patch.object(pl, "pallas_call", interp), \
            mock.patch.object(mod, "time_slope", once), \
            mock.patch.object(np.random, "RandomState", FixedInputs), \
            mock.patch.object(sys, "argv", argv):
        mod.main()
    assert len(calls) == 1, f"{name}: expected one pallas_call, saw {len(calls)}"
    out, mean = calls[0]
    assert out.dtype == jnp.bfloat16 and mean.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32)), np.asarray(mean.astype(jnp.float32))


def _ulps(ref, n):
    """n bf16 units in the last place at the largest |ref|."""
    top = float(np.abs(ref).max())
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def _port(name, q, k, v):
    out, mean = attention_variants.attention_variant(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), name)
    assert out.dtype == torch.bfloat16 and mean.dtype == torch.bfloat16
    return out.float().numpy(), mean.float().numpy()


def _close(out, mean, want_out, want_mean):
    np.testing.assert_allclose(out, want_out, rtol=0, atol=_ulps(want_out, 0.5))
    # 1e-30: entries of the clamp row underflow to f32 denormals, which XLA flushes
    np.testing.assert_allclose(mean, want_mean, rtol=2.0 ** -7, atol=1e-30)
    assert (out != want_out).mean() < 0.01 and (mean != want_mean).mean() < 0.01


@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_tpu_kernel(name):
    """The port's plain version of each variant vs the TPU kernel of the
    JAX tool in interpret mode, (1, 2, 256, 64) bf16. XLA's and PyTorch's
    exp2 differ in the last f32 bit, which can move the bf16 rounding of
    single e entries and of the stored outputs by one step: ``out`` within
    half a bf16 ulp of the largest |out| (measured: an eighth, on 39 of
    32768 entries), every ``mean`` entry within one bf16 ulp of itself
    (measured: 4 of 65536 entries differ), and fewer than 1 % of the
    entries differ at all. Rows of the mean sum to 1 (5e-3: 256 bf16
    entries)."""
    q, k, v = _bf16_inputs(1, 2, 256, 64)
    want_out, want_mean = run_jax_variant(name, q, k, v)
    out, mean = _port(name, q, k, v)
    assert out.shape == want_out.shape == (1, 2, 256, 64)
    assert mean.shape == want_mean.shape == (1, 256, 256)
    _close(out, mean, want_out, want_mean)
    np.testing.assert_allclose(mean.sum(-1), 1.0, atol=5e-3)


@pytest.mark.parametrize("d", (12, 32, 48, 128, 136, 256))
@pytest.mark.parametrize("name", NAMES)
def test_variant_matches_tpu_kernel_at_other_head_dims(name, d):
    """The port's plain version of each variant vs the TPU kernel of the
    JAX tool in interpret mode at its ``--dim d``, (1, 2, 256, d) bf16: d =
    12 (not divisible by 8: the tool calls ``pallas_call`` at any width),
    32 and 128 (the kernels' other instances), 48 (padded onto 64 on the
    card), 136 and 256 (the card's wide route, 136 padded onto 256); q is
    scaled by bf16(d^-0.5 log2 e) of that d, v6's ones follow column d.
    Tolerances of ``_close``; rows of the mean sum to 1."""
    q, k, v = _bf16_inputs(1, 2, 256, d, seed=d)
    want_out, want_mean = run_jax_variant(name, q, k, v)
    out, mean = _port(name, q, k, v)
    assert out.shape == want_out.shape == (1, 2, 256, d)
    assert mean.shape == want_mean.shape == (1, 256, 256)
    _close(out, mean, want_out, want_mean)
    np.testing.assert_allclose(mean.sum(-1), 1.0, atol=5e-3)


def test_v5_matches_tpu_kernel_above_its_old_head_limit():
    """v5's plain version vs the JAX tool's ``kern5`` in interpret mode at
    (1, 12, 128, 64) bf16: 12 heads, above the 8 the port's first v5 kernel
    took (the JAX kernel takes any head count, ``nh=hh``); one query tile
    of 128 rows, so every head of it is in the one grid step. Tolerances of
    ``_close`` (the last f32 bit of exp2 can move single bf16 e and
    outputs by one step); rows of the mean sum to 1."""
    q, k, v = _bf16_inputs(1, 12, 128, 64, seed=5)
    want_out, want_mean = run_jax_variant("v5-batched", q, k, v)
    out, mean = _port("v5-batched", q, k, v)
    assert out.shape == want_out.shape == (1, 12, 128, 64)
    assert mean.shape == want_mean.shape == (1, 128, 128)
    _close(out, mean, want_out, want_mean)
    np.testing.assert_allclose(mean.sum(-1), 1.0, atol=5e-3)


def test_v5_matches_tpu_kernel_over_query_tiles_with_three_heads():
    """v5's plain version vs the JAX tool's ``kern5`` in interpret mode at
    (1, 3, 384, 64) bf16: three grid steps of 128 query rows, and three
    heads, so the mean's one division by H is not exact in binary (the
    card kernel divides with ``__fdiv_rn``, the plain version's
    ``.mean``). Tolerances of ``_close``; rows of the mean sum to 1."""
    q, k, v = _bf16_inputs(1, 3, 384, 64, seed=6)
    want_out, want_mean = run_jax_variant("v5-batched", q, k, v)
    out, mean = _port("v5-batched", q, k, v)
    assert out.shape == want_out.shape == (1, 3, 384, 64)
    assert mean.shape == want_mean.shape == (1, 384, 384)
    _close(out, mean, want_out, want_mean)
    np.testing.assert_allclose(mean.sum(-1), 1.0, atol=5e-3)


def test_clamp_separates_v3_from_v2_in_both_packages():
    """On an input with two shifted log2 logits of one row in (100, 127)
    (110.08 and 104.30, ``clamp_case``) v2 saturates both at 2^100 and v3
    does not: the row's ``out`` and ``mean`` differ finitely between v2 and
    v3, in the JAX tool's kernels and in the port alike, and the port
    follows the JAX kernel of the same name (tolerances as above)."""
    base = [torch.from_numpy(x) for x in _bf16_inputs(1, 2, 256, 64, seed=1)]
    q, k, v = (x.numpy() for x in attention_variants.clamp_case(*base))
    got, want = {}, {}
    for name in ("v2-bf16e", "v3-nomin"):
        want[name] = run_jax_variant(name, q, k, v)
        got[name] = _port(name, q, k, v)
        for a, b in zip(got[name], want[name]):
            assert np.isfinite(a).all() and np.isfinite(b).all()
        _close(*got[name], *want[name])
    for side in (got, want):
        # the clamped row is the even mix of the two keys, the other 55:1
        np.testing.assert_allclose(side["v2-bf16e"][1][0, 3, [5, 9]], [0.5, 0.5], atol=1e-6)
        assert side["v3-nomin"][1][0, 3, 5] > 0.97 and side["v3-nomin"][1][0, 3, 9] < 0.03
        assert np.abs(side["v2-bf16e"][0][:, :, 3] - side["v3-nomin"][0][:, :, 3]).max() > 0.1
        # every other row agrees between the two variants
        rest = np.ones(256, bool)
        rest[3] = False
        np.testing.assert_array_equal(side["v2-bf16e"][0][:, :, rest],
                                      side["v3-nomin"][0][:, :, rest])


@pytest.mark.parametrize("name", NAMES)
def test_clamped_variants_agree_on_the_clamp_input(name):
    """v4, v5 and v6 clamp like v2: on the clamp input their plain
    versions give v2's ``out`` and ``mean`` exactly (the row sums are
    exact powers of two there), v3 does not."""
    base = [torch.from_numpy(x).bfloat16() for x in _bf16_inputs(1, 2, 128, 64, seed=2)]
    case = attention_variants.clamp_case(*base)
    ref = attention_variants.variant_reference(*case, "v2-bf16e")
    got = attention_variants.variant_reference(*case, name)
    same = torch.equal(got[0][:, :, 3], ref[0][:, :, 3]) and torch.equal(got[1][:, 3], ref[1][:, 3])
    assert same == (name != "v3-nomin")


@pytest.mark.parametrize("name", NAMES)
def test_variant_plain_version_at_ragged_t(name):
    """T = 200 (no multiple of 64 or 128): every row and column is
    computed, and the plain version agrees with ``attention_reference``
    without a gap. The variants round e to bf16 and shift by a constant
    where the reference subtracts the row maximum: ``out`` within 2 bf16
    ulps of the largest |out|, ``mean`` within 1 bf16 ulp of its largest
    entry."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _bf16_inputs(2, 3, 200, 64, seed=3))
    want_out, want_mean = attention.attention_reference(q, k, v, None)
    out, mean = attention_variants.attention_variant(q, k, v, name)
    assert out.shape == (2, 3, 200, 64) and mean.shape == (2, 200, 200)
    np.testing.assert_allclose(out.float().numpy(), want_out.float().numpy(), rtol=0,
                               atol=_ulps(want_out.float().numpy(), 2))
    np.testing.assert_allclose(mean.float().numpy(), want_mean.float().numpy(), rtol=0,
                               atol=_ulps(want_mean.float().numpy(), 1))


def test_variant_wrapper_counts_and_refuses():
    """CPU tensors take the plain versions and count no launch; an unknown
    name raises; the registry holds the five records with the TPU kernels
    they replace, and their d32, d128 and wide-route (dwide) records."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    reset_launches()
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _bf16_inputs(1, 2, 64, 64))
    for name in NAMES:
        attention_variants.attention_variant(q, k, v, name)
    assert all(kr.launches == 0 for kr in KERNELS.values())
    with pytest.raises(ValueError):
        attention_variants.attention_variant(q, k, v, "v7")
    lines = {"attention_v2_bf16e": 171, "attention_v3_nomin": 224, "attention_v4_mxsum": 282,
             "attention_v5_batched": 337, "attention_v6_fusedsum": 393}
    src = open(os.path.join(REPO, "tools", "analysis", "microbench_attention.py")).read().splitlines()
    for kname, line in lines.items():
        assert KERNELS[kname].replaces == f"tools/analysis/microbench_attention.py:{line}"
        assert KERNELS[kname].source == "attention_variants"
        # the cited line is the def of the function that reaches pallas_call
        assert src[line - 1].strip().startswith("def v"), src[line - 1]
    for d in ("d32", "d128", "dwide"):
        for kname, line in lines.items():
            assert KERNELS[f"{kname}_{d}"].replaces == KERNELS[kname].replaces
            assert KERNELS[f"{kname}_{d}"].source == "attention_variants"
    # 20 variant records, 16 attention instances, the head-dim-32 one-pass
    # backward, CCL and the two mean-shift routes
    assert len(KERNELS) == 40


def _c_signature(name):
    """ctypes types of the parameters of the C function ``name`` of
    ``csrc/attention_variants.cu``: a pointer is ``c_void_p``."""
    path = os.path.join(REPO, "attentionshift_torch", "csrc", "attention_variants.cu")
    found = re.search(rf"\bint {name}\(([^)]*)\)", open(path).read())
    scalars = {"int": ctypes.c_int, "float": ctypes.c_float}
    return [ctypes.c_void_p if "*" in p else scalars[p.split()[-2]]
            for p in found.group(1).split(",")]


def test_variant_library_sets_the_c_signature():
    """``variant_library`` (library mocked: no nvcc here) gives the entry
    point the argtypes of the C source's ``attn_variant_forward``: the
    variant, five tensors, the workspace, B, H, T, the instance's head dim,
    the scale, the stream; ``attn_v5_cluster`` its (B, H, T, D); and
    ``attn_wide_plan`` its (B, H, T, KD, variant, out); the ``-D``
    overrides reach the build."""
    built = []
    fake = types.SimpleNamespace(
        attn_variant_forward=types.SimpleNamespace(argtypes=None, restype=None),
        attn_v5_cluster=types.SimpleNamespace(argtypes=None, restype=None),
        attn_wide_plan=types.SimpleNamespace(argtypes=None, restype=None))

    def library(source, defines=()):
        built.append((source, defines))
        return fake

    with mock.patch.object(attention_variants, "library", library):
        lib = attention_variants.variant_library(("VAR_STAGES=3",))
    assert lib is fake and built == [("attention_variants", ("VAR_STAGES=3",))]
    want = _c_signature("attn_variant_forward")
    assert want == ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
    assert fake.attn_variant_forward.argtypes == want
    assert fake.attn_variant_forward.restype is ctypes.c_int
    assert fake.attn_v5_cluster.argtypes == _c_signature("attn_v5_cluster") == [ctypes.c_int] * 4
    assert fake.attn_v5_cluster.restype is ctypes.c_int
    assert fake.attn_wide_plan.argtypes == _c_signature("attn_wide_plan") == (
        [ctypes.c_int] * 5 + [ctypes.c_void_p])
    assert fake.attn_wide_plan.restype is ctypes.c_int


@pytest.mark.parametrize("name", NAMES)
def test_variant_launch_hands_workspace_and_counts(name):
    """The launch path with the library's function mocked (CPU tensors,
    (2, 3, 40, 64)): one call per variant call with as many arguments as
    the C signature has; every variant gets a (B, H, T) f32 workspace
    distinct from every tensor (v5 writes it only above 24 heads); the
    instance's head dim is 64 and q, k (no padding) are handed as they are;
    the scale is bf16(d^-0.5 log2 e); one launch is counted per call, none
    when the call fails."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    q, k, v = (torch.from_numpy(x).bfloat16() for x in _bf16_inputs(2, 3, 40, 64))
    kernel, number = attention_variants.VARIANTS[name]
    calls, made = [], []
    workspace = attention_variants._workspace

    def fn(*args):
        calls.append(args)
        return 0

    def recorded(q):
        made.append(workspace(q))
        return made[-1]

    reset_launches()
    with mock.patch.object(attention_variants, "_workspace", recorded):
        for i in (1, 2):
            out, mean = attention_variants._launch(fn, name, q, k, v, 7)
            assert KERNELS[kernel].launches == i
            assert sum(kr.launches for kr in KERNELS.values()) == i
        with pytest.raises(RuntimeError, match="cudaError_t 700"):
            attention_variants._launch(lambda *a: 700, name, q, k, v, 7)
    assert KERNELS[kernel].launches == 2
    args = calls[-1]
    assert len(args) == len(_c_signature("attn_variant_forward"))
    got_number, pq, pk, pv, pout, pmean, pwork, b, h, t, kd, scale, stream = args
    assert (got_number, b, h, t, kd, stream) == (number, 2, 3, 40, 64, 7)
    assert scale == float(torch.tensor(64**-0.5 * 1.4426950408889634).bfloat16())
    assert (pq, pk, pout, pmean) == (q.data_ptr(), k.data_ptr(), out.data_ptr(), mean.data_ptr())
    assert out.shape == (2, 3, 40, 64) and mean.shape == (2, 40, 40)
    work = made[1]
    assert work.shape == (2, 3, 40) and work.dtype == torch.float32
    assert pwork == work.data_ptr()
    assert pwork not in (pq, pk, pv, pout, pmean)
    if name == "v6-fusedsum":
        assert pv != v.data_ptr()  # V with its 8 columns of ones
    else:
        assert pv == v.data_ptr()


@pytest.mark.parametrize("d,kd", [(12, 32), (48, 64), (100, 128), (128, 128), (136, 256),
                                  (256, 256), (520, 640)])
@pytest.mark.parametrize("name", NAMES)
def test_variant_launch_pads_onto_the_instance(name, d, kd):
    """The launch path at head dim ``d`` with the library's function mocked
    (CPU tensors): q, k, v reach the kernel zero-padded to the instance's
    head dim ``kd`` (v6's V as (B, H, T, kd + 8), its ones in columns kd on),
    the C call gets ``kd`` and the scale of the true d, ``out`` comes back
    sliced to d and contiguous, and one launch of ``kd``'s record is
    counted (``<record>_d32``, ``_d128``, ``_dwide`` above 128; the record
    itself at 64)."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    q, k, v = (torch.from_numpy(x).bfloat16() for x in _bf16_inputs(1, 2, 24, d, seed=d))
    seen = {}

    def fn(number, pq, pk, pv, pout, pmean, pwork, b, h, t, got_kd, scale, stream):
        seen.update(kd=got_kd, scale=scale, ptrs=(pq, pk, pv, pout))
        return 0

    handed = []
    real_pad = attention_variants.pad_head
    ones = attention_variants._with_ones

    def pad(x, width):
        handed.append(real_pad(x, width))
        return handed[-1]

    with mock.patch.object(attention_variants, "pad_head", pad), \
            mock.patch.object(attention_variants, "_with_ones",
                              lambda x: handed.append(ones(x)) or handed[-1]):
        reset_launches()
        out, mean = attention_variants._launch(fn, name, q, k, v, 0)
    assert seen["kd"] == kd
    assert seen["scale"] == float(torch.tensor(d**-0.5 * 1.4426950408889634).bfloat16())
    qp, kp, vp = handed[:3]
    for x, p in ((q, qp), (k, kp), (v, vp)):
        assert p.shape == (1, 2, 24, kd) and p.is_contiguous()
        assert torch.equal(p[..., :d], x) and not p[..., d:].any()
    if name == "v6-fusedsum":
        vx = handed[3]
        assert vx.shape == (1, 2, 24, kd + 8) and torch.equal(vx[..., :kd], vp)
        assert bool((vx[..., kd:] == 1).all())
        assert seen["ptrs"][2] == vx.data_ptr()
    else:
        assert seen["ptrs"][2] == vp.data_ptr()
    assert seen["ptrs"][:2] == (qp.data_ptr(), kp.data_ptr())
    assert out.shape == q.shape and out.is_contiguous() and mean.shape == (1, 24, 24)
    record = attention_variants.variant_kernel(name, kd)
    suffix = "" if kd == 64 else ("_dwide" if kd > 128 else f"_d{kd}")
    assert record == attention_variants.VARIANTS[name][0] + suffix
    assert {n: r.launches for n, r in KERNELS.items() if r.launches} == {record: 1}


@pytest.mark.parametrize("d", (136, 200, 520))
@pytest.mark.parametrize("name", NAMES)
def test_padding_onto_the_wide_width_is_exact(name, d):
    """What the card's wide route computes, run through the plain version:
    q, k, v zero-padded to 128 * ceil(d / 128) (``variant_head_dim``; v6's
    ones after the padded width), scaled by bf16(d^-0.5 log2 e) of the true
    d, give bitwise the unpadded plain version's ``out`` (sliced back) and
    ``mean``, (1, 2, 64, d). Control: the padded width's own scale (what a
    wrapper that forgot the true d would hand over) changes them."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _bf16_inputs(1, 2, 64, d, seed=d + 1))
    kd = attention_variants.variant_head_dim(d)
    assert kd == (256 if d < 256 else 640)
    want = attention_variants.variant_reference(q, k, v, name)
    padded = [attention_variants.pad_head(x, kd) for x in (q, k, v)]
    scale = attention_variants._q_scale(q)
    with mock.patch.object(attention_variants, "_q_scale", lambda x: scale):
        got = attention_variants.variant_reference(*padded, name)
    assert torch.equal(got[0][..., :d], want[0]) and torch.equal(got[1], want[1])
    assert not got[0][..., d:].any()
    ctl = attention_variants.variant_reference(*padded, name)
    assert float(attention_variants._q_scale(padded[0])) != float(scale)
    assert not (torch.equal(ctl[0][..., :d], want[0]) and torch.equal(ctl[1], want[1]))


def _logits_f64(q, k):
    """The plain version's shifted logits with the products summed in f64
    and rounded to f32: the same values in another summation order."""
    qs = q * attention_variants._q_scale(q)
    return torch.matmul(qs.double(), k.double().transpose(-1, -2)).float() - 20.0


@pytest.mark.parametrize("name", ["v2-bf16e", "v3-nomin", "v4-mxsum", "v5-batched",
                                  "v6-fusedsum"])
def test_mean_limit_passes_rounding_and_sees_the_clamp(name):
    """``mean_limit``, the per-entry limit of the card checks, at the card
    case (1, 24, 190) for seeds 0-15: the plain version with its logits
    summed in another order (f64 products rounded to f32) moves single
    bf16 e and mean entries, and stays within the limit (measured: 6
    entries moved over the 16 seeds, each by one step, 0.18 of the
    limit); on the clamp input the plain version of the other clamp
    behaviour exceeds it on some entry (measured: by 45x or more), so the
    limit still sees the clamp. No floor is added: no shifted logit of
    these inputs is below -126."""
    other = "v2-bf16e" if name == "v3-nomin" else "v3-nomin"
    moved = 0
    for seed in range(16):
        q, k, v = (torch.from_numpy(x).bfloat16() for x in _bf16_inputs(1, 24, 190, 64, seed=seed))
        want = attention_variants.variant_reference(q, k, v, name)[1]
        limit = attention_variants.mean_limit(q, k, name, want)
        assert torch.equal(limit, attention_variants.MEAN_LIMIT_STEPS
                           * attention_variants.bf16_steps(want))
        with mock.patch.object(attention_variants, "_logits", _logits_f64):
            got = attention_variants.variant_reference(q, k, v, name)[1]
        err = (got.float() - want.float()).abs()
        assert bool((err <= limit).all()), f"seed {seed}: {float((err / limit).max())}x the limit"
        moved += int((got != want).sum())
        case = attention_variants.clamp_case(q, k, v)
        clamp_mean = attention_variants.variant_reference(*case, name)[1]
        ctl = attention_variants.variant_reference(*case, other)[1]
        ctl_limit = attention_variants.mean_limit(case[0], case[1], other, ctl)
        assert bool(((clamp_mean.float() - ctl.float()).abs() > ctl_limit).any()), seed
    assert moved > 0  # the other order does move entries: the check above is not empty


def test_mean_limit_steps_and_flush_floor():
    """``bf16_steps`` is the bf16 spacing at each entry (2^-133 below
    2^-126 and at 0); ``mean_limit`` adds its ftz floor only on the rows
    where a shifted log2 logit falls below -126: 2^-126 times the row's
    reciprocal row sums (1 / max(sum, 1e-30), as the plain version takes
    them), averaged over the heads. A zero mean isolates the floor: its
    steps are 2^-133."""
    x = torch.tensor([1.0, 1.5, 2.0, 0.75, 2.0**-126, 2.0**-130, 0.0, 1e-3]).bfloat16()
    want = [2.0**-7, 2.0**-7, 2.0**-6, 2.0**-8, 2.0**-133, 2.0**-133, 2.0**-133, 2.0**-17]
    assert attention_variants.bf16_steps(x).tolist() == want
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _bf16_inputs(1, 2, 16, 64, seed=4))
    q[0, 1, 5] = -8.0  # head 1, row 5: logits of about -8 * 64 * 0.18 * k, far below -126
    k[0, 1] = k[0, 1].abs() + 0.5
    extra = attention_variants.mean_limit(q, k, "v2-bf16e", torch.zeros((1, 16, 16))) - 5.5 * 2.0**-133
    rows = (extra > 0).any(dim=-1)[0]
    assert rows.tolist() == [r == 5 for r in range(16)]
    s = attention_variants._logits(q, k).clamp(max=100.0)
    recip = 1.0 / torch.exp2(s).bfloat16().float().sum(-1).clamp_min(1e-30)
    np.testing.assert_allclose(extra[0, 5].numpy(), 2.0**-126 * float(recip[0, 1, 5]) / 2, rtol=1e-6)


def test_variant_kernel_refuses_what_it_refused_before():
    """The kernel path's input checks (reached here directly: a CPU
    tensor takes the plain version): f32 inputs and unequal shapes are
    refused for what they are; every head dim from 1 to 128 passes the
    width check, and so do 136 and 256 (the wide route: the check once
    refused everything above 128), and every variant, v5 included (its
    first design refused more than 8 heads), takes any head count (9, 24:
    only the device is wrong here)."""
    check = attention_variants._check_inputs

    def bf(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    with pytest.raises(ValueError, match="bfloat16"):
        check(*(torch.zeros((1, 2, 64, 64)),) * 3, "v2-bf16e")
    for d in (136, 256):
        with pytest.raises(ValueError, match="CUDA tensors"):
            check(*(bf(1, 2, 64, d),) * 3, "v4-mxsum")
    for d in range(1, 129):
        with pytest.raises(ValueError, match="CUDA tensors"):
            check(*(bf(1, 1, 8, d),) * 3, "v4-mxsum")
    with pytest.raises(ValueError, match="shapes differ"):
        check(bf(1, 2, 64, 64), bf(1, 2, 65, 64), bf(1, 2, 64, 64), "v2-bf16e")
    for name in NAMES:
        for h in (1, 9, 24):
            with pytest.raises(ValueError, match="CUDA tensors"):
                check(*(bf(2, h, 40, 64),) * 3, name)


def test_tool_runs_every_variant_on_the_cpu():
    """``run_variants`` on the CPU at a small shape: a finite positive
    time for each of the nine names, one printed line each naming the
    device, in the tool's order."""
    lines = []
    res = tool.run_variants(t=256, heads=2, dim=64, inner=2, device="cpu", iters=2,
                            log=lines.append)
    assert list(res) == list(tool.VARIANT_NAMES)
    assert set(tool.VARIANT_NAMES) == {"ours-capture", "ours-nocapture", "library", "plain",
                                       *NAMES}
    assert all(math.isfinite(ms) and ms > 0 for ms in res.values())
    assert len(lines) == len(res)
    for name, line in zip(res, lines):
        assert line.startswith(name) and "ms/layer" in line and "cpu" in line


def test_tool_selects_variants_and_refuses_unknown_names():
    res = tool.run_variants(t=100, heads=2, inner=1, iters=1, device="cpu",
                            variants=["v6-fusedsum", "library"], log=lambda _: None)
    assert list(res) == ["v6-fusedsum", "library"]
    with pytest.raises(ValueError):
        tool.run_variants(t=64, heads=1, device="cpu", variants=["stock-flash"])


def test_tool_needs_a_card_unless_asked_for_the_cpu(capsys):
    """Without a card, the default device (cuda) raises; ``--device cpu``
    runs and prints the sorted dict last."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.run_variants(t=64, heads=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["--t", "64", "--heads", "1"])
    res = tool.main(["--t", "64", "--heads", "1", "--inner", "1", "--variants", "plain,v2-bf16e",
                     "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert set(res) == {"plain", "v2-bf16e"}
    assert out[-1].startswith("{") and "cpu" in out[-1]
