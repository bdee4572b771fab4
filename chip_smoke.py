"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
1. the card's name and power limit (nvidia-smi), and whether PIL, cv2,
   orbax, scipy and einops import there (reported; nothing here needs them);
2. build every kernel of ``attentionshift_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all at once;
3. each kernel at the bench shapes against its plain PyTorch version on
   the card, with the tolerance stated beside each check (the flash
   pass's row log2-sum-exp against the plain version's f32 logits; the two
   attention backward kernels included: gap columns of dK/dV exactly 0,
   and once more at the microbenchmark's ragged T = 4301 without a gap;
   the five design variants of the attention microbenchmark included,
   also on an input that tells the clamped variants from the unclamped;
   every kernel the microbenchmark launches also on its own inputs,
   (1, 6, 4301, 64): an odd T with a ragged last tile);
4. ``AttnShiftDetector.seed_pseudo_gt`` at the full width of
   ``configs/attnshift_voc12aug.py`` (ViT-S) with seeded random weights,
   800x1344, bf16: output shapes, finite maps, and kernel launch counts
   of that path (exactly 7/5/1/1 per image);
5. single-scale inference: ``simple_test`` through ``make_eval_step`` on
   the same model as configured (1000 proposals, 100 detections, score
   floor 0.05): shapes, finite values, boxes inside the true extent, mask
   probabilities in [0, 1], launches exactly 0 capture / 12 plain and no
   other kernel; once more with a lowered score floor, so that detections
   are sure to survive the seeded random heads and be checked (every timed
   call runs as configured);
6. the train path: three steps of ``make_train_step`` on the same model
   and inputs (bf16, activation checkpointing on, layer-decay AdamW):
   finite losses with the expected keys, a non-zero gradient in every
   submodule, parameters changed, and the exact launch counts per step;
7. the attention microbenchmark
   (``attentionshift_torch.tools.analysis.microbench_attention``) at its
   defaults, every variant, its lines printed, its launches counted;
8. times with CUDA events: every kernel, its plain version, the library
   call where one exists, ms/img of the pseudo-label path and of
   inference and ms per train step, each with one profiled call. The
   attention kernels and their SDPA yardsticks (the forward with the same
   mask; the backward of it beside the backward pair) are read in turns,
   kernel, library, library, kernel, ..., and each reports the median of
   its readings; the flash pass's and the backward pair's TFLOP/s and
   ratio to SDPA, the mean pass's own time, and an exp floor (B*H*T^2
   exp2 per pass at 16 per clock per SM, at the SM clock nvidia-smi reads
   while the flash pass runs) beside the forward bounds.

A failing phase raises and the script exits non-zero. The line before
the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.

    python3 chip_smoke.py --ablate [SOURCE ...]

runs, after phase 1, only the ablation of design constants instead: each
source of ``ABLATIONS`` (default: attention, meanshift, ccl) built once
per variant (``-D`` overrides of the constants it guards with
``#ifndef``), every variant checked as in phase 3 at the bench shape,
then the variants read in turns (median of 6 readings of 20 launches
each): the attention forward pair's flash pass with SDPA's forward and
its mean pass; the mean-shift fixpoint (bf16) and CCL on phase 3's
inputs.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# bench geometry (bench.py:110-131,222-234)
H_IMG, W_IMG, MAX_GT, N_VALID = 800, 1344, 20, 8
HEADS, HEAD_DIM, EMBED = 6, 64, 384
T_TOK = 1 + (H_IMG // 16) * (W_IMG // 16) + 100  # 4301
T_PAD = -(-T_TOK // 128) * 128  # 4352
PAD_GAP = (1 + (H_IMG // 16) * (W_IMG // 16), 1 + (H_IMG // 16) * (W_IMG // 16) + T_PAD - T_TOK)
CAM_LAYERS = 7

# published H100 SXM peaks (NVIDIA data sheet; dense)
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
EXP2_PER_CLOCK_PER_SM = 16  # MUFU results per clock per SM
LOG2E = 1.4426950408889634

# design constants each source guards with #ifndef, built as variants by
# --ablate: source -> variant -> -D overrides
ABLATIONS = {
    "attention": {
        "as built": (),
        "flash: 1 warpgroup and 3 blocks per SM": ("FWD_WARPGROUPS=1", "FWD_BLOCKS_PER_SM=3"),
        "flash: 3 ring slots": ("FWD_STAGES=3",),
        "flash: 5 ring slots": ("FWD_STAGES=5",),
        "mean: 3 ring slots": ("MEAN_STAGES=3",),
        "mean: chunks of at most 2 key tiles": ("MEAN_MAX_CHUNK=2",),
    },
    "meanshift": {
        "as built": (),
        "update: 2 boxes per warpgroup at once": ("MS_ROUND_BOXES=2",),
        "reductions: rows in 2 parts": ("MS_ROW_PARTS=2",),
        "reductions: rows in 8 parts": ("MS_ROW_PARTS=8",),
    },
    "ccl": {
        "as built": (),
        "512 threads": ("CCL_THREADS=512",),
        "256 threads": ("CCL_THREADS=256",),
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # packages that later slices of the port would lean on (image resize,
    # checkpoint format): reported, nothing here needs them. Each import runs
    # in a process of its own, so that none of them loads into this one.
    for mod in ("PIL", "cv2", "orbax.checkpoint", "scipy", "einops"):
        r = subprocess.run([sys.executable, "-c", f"import {mod}"], capture_output=True,
                           text=True, timeout=120)
        why = "" if r.returncode == 0 else f" ({(r.stderr.strip().splitlines() or ['?'])[-1][:100]})"
        log(f"[card] import {mod}: {'ok' if r.returncode == 0 else 'fails'}{why}")
    return smi


def phase_build(targets=None):
    """Build every kernel source (or each (source, defines) of ``targets``),
    printing ptxas's registers and spills."""
    from attentionshift_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(targets)
    dt = time.perf_counter() - t0
    for (src, defines), out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {' '.join((src, *defines))}: {line.strip()}")
    log(f"[build] {len(logs)} sources built in {dt:.1f} s into {_build.BUILD_DIR}")


def cuda_time(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` launches, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_time(fn, n: int = 5, reps: int = 10) -> float:
    """Median ms of ``n`` readings of ``cuda_time(fn, reps)``."""
    import statistics

    return statistics.median(cuda_time(fn, reps=reps, warmup=1) for _ in range(n))


def in_turns(*fns, rounds: int = 6, reps: int = 10):
    """Readings of the functions taken in turns, every other round
    backwards (a, b, b, a, a, b, ...): the median ms of each, and the
    readings of each."""
    import statistics

    got = [[] for _ in fns]
    for r in range(rounds):
        for i in (range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))):
            got[i].append(cuda_time(fns[i], reps=reps, warmup=1))
    return [statistics.median(g) for g in got], got


def sm_clock_under_load(fn, seconds: float = 0.6) -> tuple[float, float]:
    """The SM clock (MHz) that nvidia-smi reads while ``fn`` runs back to
    back on the card, and the card's maximum SM clock."""
    import torch

    probe = subprocess.Popen(
        ["bash", "-c", "sleep 0.25; nvidia-smi --query-gpu=clocks.sm,clocks.max.sm "
                       "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while probe.poll() is None and time.perf_counter() - t0 < seconds:
        for _ in range(50):
            fn()
    out, _ = probe.communicate(timeout=60)
    torch.cuda.synchronize()
    cur, top = (float(x) for x in out.strip().splitlines()[0].split(","))
    return cur, top


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def expect(name: str, err: float, tol: float, why: str) -> None:
    ok = err <= tol
    log(f"[check] {name}: max_abs_err {err:.3e} <= {tol:.1e} ({why}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")


def bf16_ulps(ref, n: int) -> float:
    """``n`` units in the last place of bf16 (8 significant bits) at the
    largest |ref|."""
    import math

    top = max(float(ref.float().abs().max()), 1e-30)
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def blob_masks(m: int, h: int, w: int, gen, device):
    """(m, h, w) bool blob masks: blurred noise thresholded per plane; the
    last quarter of the planes empty, as padded instances are."""
    import torch
    import torch.nn.functional as F

    x = torch.rand((m, 1, h, w), generator=gen, device=device)
    for _ in range(3):
        x = F.avg_pool2d(x, 7, stride=1, padding=3, count_include_pad=False)
    thr = x.flatten(1).quantile(0.7, dim=1)[:, None, None, None]
    masks = (x > thr)[:, 0]
    masks[3 * m // 4:] = False
    return masks


def bench_qkv(dev, gen):
    """q, k, v (1, 6, 4352, 64) bf16 (seeded)."""
    import torch

    shape = (1, HEADS, T_PAD, HEAD_DIM)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))


def kernel_inputs(dev, gen):
    """Each kernel's inputs at the bench shapes (seeded)."""
    import torch

    qkv = bench_qkv(dev, gen)
    shape = qkv[0].shape
    masks = blob_masks(CAM_LAYERS * MAX_GT, H_IMG // 16, W_IMG // 16, gen, dev)
    g, n, d = MAX_GT, (H_IMG // 16) * (W_IMG // 16), EMBED
    f = torch.randn((n, d), generator=gen, device=dev)
    prot0 = torch.randn((g, 20, d), generator=gen, device=dev)
    ys = torch.arange(H_IMG // 16, device=dev)[:, None]
    xs = torch.arange(W_IMG // 16, device=dev)[None, :]
    lo = torch.randint(0, 20, (g, 2), generator=gen, device=dev)
    box = ((ys[None] >= lo[:, 0, None, None]) & (ys[None] < lo[:, 0, None, None] + 30)
           & (xs[None] >= lo[:, 1, None, None]) & (xs[None] < lo[:, 1, None, None] + 60))
    mask = box.reshape(g, n).float()
    mask[N_VALID:] = 0.0
    # the attention's upstream gradient: rows in the gap are zero in the model
    g_out = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g_out[:, :, PAD_GAP[0]:PAD_GAP[1]] = 0
    # what the microbenchmark hands its kernels: (1, 6, 4301, 64), no gap
    from attentionshift_torch.tools.analysis.microbench_attention import make_inputs

    tool_qkv = make_inputs(device=dev)
    assert tuple(tool_qkv[0].shape) == (1, HEADS, T_TOK, HEAD_DIM)
    # an upstream gradient at that shape: the backward pair at a ragged T
    tool_g = torch.randn(tool_qkv[0].shape, generator=gen, device=dev).to(torch.bfloat16)
    return dict(qkv=qkv, tool_qkv=tool_qkv, tool_g=tool_g, g_out=g_out, masks=masks,
                prot0=prot0, mask=mask, f=f)


def phase_kernels(results: dict, inp: dict):
    """Each kernel against its plain version at the bench shapes."""
    import torch

    from attentionshift_torch.ops import attention, ccl, meanshift_kernel

    q, k, v = inp["qkv"]
    ref_out, ref_mean = attention.attention_reference(q, k, v, PAD_GAP)
    out, mean = attention.attention_with_capture(q, k, v, PAD_GAP)
    sync()
    e_out = max_err(out, ref_out)
    e_mean = max_err(mean, ref_mean)
    out_tol = bf16_ulps(ref_out, 4)
    why_out = "4 bf16 ulps of the largest |out|: bf16 output and bf16 probabilities in PV"
    expect("attention_capture.out", e_out, out_tol, why_out)
    # control: the same check against a plain version that ignores the gap
    # must fail, or it could not tell a kernel that drops the gap mask
    e_nogap = max_err(out, attention.attention_reference(q, k, v, None)[0])
    log(f"[check] attention.out control (plain version without the gap): max_abs_err "
        f"{e_nogap:.3e} must exceed {out_tol:.1e}: {'ok' if e_nogap > out_tol else 'FAIL'}")
    if not e_nogap > out_tol:
        raise AssertionError(f"attention.out check cannot see the pad gap: {e_nogap} <= {out_tol}")
    expect("attention_capture.mean", e_mean, 2e-3 * float(ref_mean.float().abs().max()),
           "bf16 storage of the mean: 2^-9 relative, times the largest entry")
    gap = mean[:, :, PAD_GAP[0]:PAD_GAP[1]].float().abs().max().item()
    expect("attention_capture.gap_columns", gap, 0.0, "pad-gap columns carry exactly 0")
    results["attention_capture"] = dict(max_abs_err=max(e_out, e_mean))
    # the row log2-sum-exp the mean pass and the backward normalise with
    _, lse = attention.flash_forward(q, k, v, PAD_GAP, with_lse=True)
    logits = torch.matmul((q * HEAD_DIM**-0.5).float(), k.float().transpose(-1, -2))
    logits[..., PAD_GAP[0]:PAD_GAP[1]] = float("-inf")
    want_lse = torch.logsumexp(logits, dim=-1) * LOG2E
    expect("attention.lse2", max_err(lse, want_lse), 1e-4,
           "logsumexp of the plain version's f32 logits x log2(e): f32 summation order only")
    del logits, want_lse, lse

    out2 = attention.attention_no_capture(q, k, v, PAD_GAP)
    sync()
    e2 = max_err(out2, ref_out)
    expect("attention_plain.out", e2, out_tol, why_out)
    results["attention_plain"] = dict(max_abs_err=e2)
    del ref_out, ref_mean, out, mean, out2

    # both again as the microbenchmark calls them: its inputs, odd T, no gap
    tq, tk, tv = inp["tool_qkv"]
    ref_out, ref_mean = attention.attention_reference(tq, tk, tv, None)
    out, mean = attention.attention_with_capture(tq, tk, tv)
    out2 = attention.attention_no_capture(tq, tk, tv)
    sync()
    out_tol = bf16_ulps(ref_out, 4)
    expect("attention_capture.tool_input.out", max_err(out, ref_out), out_tol, why_out)
    expect("attention_capture.tool_input.mean", max_err(mean, ref_mean),
           2e-3 * float(ref_mean.float().abs().max()),
           "bf16 storage of the mean: 2^-9 relative, times the largest entry")
    expect("attention_plain.tool_input.out", max_err(out2, ref_out), out_tol, why_out)
    del ref_out, ref_mean, out, mean, out2

    phase_backward_kernels(results, inp)
    phase_variant_kernels(results, inp)

    masks = inp["masks"]
    ref_lab = ccl.connected_components(masks, 64)
    lab = ccl.connected_components_batch(masks, 64)
    sync()
    e3 = max_err(lab, ref_lab)
    expect("ccl_batch", e3, 0.0, "integer labels: exact")
    results["ccl_batch"] = dict(max_abs_err=e3)

    prot0, mask, f = inp["prot0"], inp["mask"], inp["f"]
    errs = []
    refs = {}
    for mm, tol, why in (
        (None, 1e-4, "f32: summation order only"),
        (torch.bfloat16, 2e-3, "bf16 dot operands: an f32 last-bit difference can move a bf16 "
                               "rounding of a weight or prototype by 2^-8"),
    ):
        ref_p, ref_s = refs[mm] = meanshift_kernel.cosine_shift_batch(
            prot0, f[None] * mask[..., None], f, n_shift=10, matmul_dtype=mm)
        got_p, got_s = meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, n_shift=10,
                                                              matmul_dtype=mm)
        sync()
        tag = "f32" if mm is None else "bf16"
        ep_abs = max_err(got_p, ref_p)
        es = max_err(got_s, ref_s)
        expect(f"meanshift_fixpoint.{tag}.prototypes(rel)",
               ep_abs / max(float(ref_p.abs().max()), 1e-6), tol, why)
        expect(f"meanshift_fixpoint.{tag}.sim", es, tol, why)
        errs.append(max(ep_abs, es))
    # controls: the bf16 kernel against plain versions that differ from it
    # (f32 operands; a softmax temperature 10 % off) must fail the bf16 check
    refs["temp"] = meanshift_kernel.cosine_shift_batch(
        prot0, f[None] * mask[..., None], f, temp=0.11, n_shift=10, matmul_dtype=torch.bfloat16)
    for name, key in (("f32 operands", None), ("temp 0.11", "temp")):
        ref_p, ref_s = refs[key]
        ctl_p = max_err(got_p, ref_p) / max(float(ref_p.abs().max()), 1e-6)
        ctl_s = max_err(got_s, ref_s)
        fails = max(ctl_p, ctl_s) > tol
        log(f"[check] meanshift bf16 control (plain version with {name}): prototypes(rel) "
            f"{ctl_p:.3e}, sim {ctl_s:.3e}, one must exceed {tol:.1e}: {'ok' if fails else 'FAIL'}")
        if not fails:
            raise AssertionError(f"meanshift bf16 check cannot see {name}: {ctl_p}, {ctl_s}")
    # the main path's mode (bf16 dot operands)
    results["meanshift_fixpoint"] = dict(max_abs_err=errs[-1])


def phase_backward_kernels(results: dict, inp: dict):
    """Both attention backward kernels, through the attention ops'
    autograd, against the plain backward at the bench shape (with its
    gap) and at the microbenchmark's ragged T = 4301 without a gap. The
    errors kept for the kernel table are the bench shape's."""
    import torch

    from attentionshift_torch.ops import attention

    q, k, v = inp["qkv"]
    g = inp["g_out"]
    want = attention.attention_backward_reference(q, k, v, g, PAD_GAP)
    no_gap = attention.attention_backward_reference(q, k, v, g, None)
    errs = {}
    for op in (attention.attention_no_capture, attention.attention_with_capture):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = op(*leaves, PAD_GAP)
        out = out[0] if isinstance(out, tuple) else out
        got = torch.autograd.grad(out, leaves, g)
        sync()
        why = ("4 bf16 ulps of the largest gradient: bf16 gradients, and the kernels normalise "
               "with the forward's row statistic and take D from the bf16 out")
        for name, a, b, c in zip(("dq", "dk", "dv"), got, want, no_gap):
            tol = bf16_ulps(b, 4)
            e = max_err(a, b)
            expect(f"attention_bwd.{op.__name__}.{name}", e, tol, why)
            errs[name] = max(errs.get(name, 0.0), e)
            # control: a plain backward that ignores the gap must fail the limit
            ctl = max_err(a, c)
            log(f"[check] attention_bwd.{name} control (plain backward without the gap): "
                f"max_abs_err {ctl:.3e} must exceed {tol:.1e}: {'ok' if ctl > tol else 'FAIL'}")
            if not ctl > tol:
                raise AssertionError(f"attention_bwd.{name} check cannot see the pad gap")
        for name, a in (("dk", got[1]), ("dv", got[2])):
            gap = float(a[:, :, PAD_GAP[0]:PAD_GAP[1]].float().abs().max())
            expect(f"attention_bwd.{op.__name__}.{name}.gap_columns", gap, 0.0,
                   "pad-gap columns carry exactly 0")
    results["attention_bwd_dq"] = dict(max_abs_err=errs["dq"])
    results["attention_bwd_dkv"] = dict(max_abs_err=max(errs["dk"], errs["dv"]))
    del want, no_gap
    tq, tk, tv = inp["tool_qkv"]
    want = attention.attention_backward_reference(tq, tk, tv, inp["tool_g"], None)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    got = torch.autograd.grad(attention.attention_no_capture(*leaves), leaves, inp["tool_g"])
    sync()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        expect(f"attention_bwd.tool_input.{name}", max_err(a, b), bf16_ulps(b, 4),
               "4 bf16 ulps of the largest gradient, T = 4301: a ragged last tile")


def phase_variant_kernels(results: dict, inp: dict):
    """The five design variants of the attention microbenchmark against
    their plain versions, bf16, no gap: on the microbenchmark's own inputs
    at (1, 6, 4301, 64) (odd T, ragged last tile: the shape every launch
    of the tool has), at (1, 6, 4352, 64) on the bench inputs, and there
    on the clamp input (two shifted log2 logits of one row in (100, 127)).
    Control: on the clamp input the plain version of the other clamp
    behaviour must exceed both limits. The error kept for the kernel table
    is the one on the microbenchmark's inputs."""
    from attentionshift_torch.ops import attention_variants as av

    q, k, v = inp["qkv"]
    cases = ((".tool_input", inp["tool_qkv"]), (".bench_input", (q, k, v)),
             (".clamp_input", av.clamp_case(q, k, v)))
    for name, (kernel, _) in av.VARIANTS.items():
        errs = []
        for tag, case in cases:
            want_out, want_mean = av.variant_reference(*case, name)
            out, mean = av.attention_variant(*case, name)
            sync()
            out_tol = bf16_ulps(want_out, 4)
            mean_tol = 2e-3 * float(want_mean.float().abs().max())
            e_out, e_mean = max_err(out, want_out), max_err(mean, want_mean)
            expect(f"{kernel}{tag}.out", e_out, out_tol,
                   "4 bf16 ulps of the largest |out|: bf16 output, bf16 e in PV")
            expect(f"{kernel}{tag}.mean", e_mean, mean_tol,
                   "bf16 storage of the mean: 2^-9 relative, times the largest entry")
            errs.append(max(e_out, e_mean))
            del want_out, want_mean
        # still the clamp input: v3's plain version for the clamped kernels, v2's for v3
        other = "v2-bf16e" if name == "v3-nomin" else "v3-nomin"
        ctl_out, ctl_mean = av.variant_reference(*cases[-1][1], other)
        c_out, c_mean = max_err(out, ctl_out), max_err(mean, ctl_mean)
        ok = c_out > out_tol and c_mean > mean_tol
        log(f"[check] {kernel} control (plain {other} on the clamp input): out {c_out:.3e} must "
            f"exceed {out_tol:.1e}, mean {c_mean:.3e} must exceed {mean_tol:.1e}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel}: the check cannot see the clamp: {c_out}, {c_mean}")
        del ctl_out, ctl_mean, out, mean
        results[kernel] = dict(max_abs_err=errs[0])


def slice_inputs(h, w, g, n_valid, dev):
    """bench.py's inputs (bench.py:222-234) at (h, w)."""
    import numpy as np
    import torch

    img = torch.from_numpy(np.random.RandomState(0).randn(1, h, w, 3).astype(np.float32))
    pts = torch.from_numpy((np.random.RandomState(1).rand(1, g, 2) * [w * 0.9, h * 0.9] + 10)
                           .astype(np.float32))
    lbls = torch.from_numpy(np.random.RandomState(2).randint(0, 20, (1, g)).astype(np.int32))
    valid = torch.tensor([[True] * n_valid + [False] * (g - n_valid)])
    wh = torch.tensor([[float(w), float(h)]])
    return tuple(t.to(dev) for t in (img, pts, lbls, valid, wh))


def build_model(dev, dtype, **overrides):
    import torch  # noqa: F401

    from attentionshift_torch.models import AttnShiftDetector

    cfg = os.path.join(HERE, "configs", "attnshift_voc12aug.py")
    kw = dict(max_gt=MAX_GT, pad_tokens_to=128, dtype=dtype)
    kw.update(overrides)
    return AttnShiftDetector.from_config(cfg, device=dev, **kw).init_weights(seed=0)


def check_outputs(out: dict, h: int, w: int, g: int, n_valid: int) -> None:
    import torch

    shapes = dict(
        pseudo_gt_bboxes=(1, g, 4), pseudo_gt_labels=(1, g), pseudo_gt_valid=(1, g),
        pseudo_gt_masks=(1, g, h, w), mask_points_coords=(1, g, 16, 2),
        mask_points_labels=(1, g, 16), map_cos_fg=(1, g, h, w), semantic_centers=(1, g, 6, 2),
        semantic_centers_valid=(1, g, 6), best_attn_idx=(1, g), loss_mil=(),
    )
    assert set(out) == set(shapes), sorted(out)
    for key, shape in shapes.items():
        assert tuple(out[key].shape) == shape, (key, tuple(out[key].shape), shape)
    for key in ("pseudo_gt_bboxes", "map_cos_fg", "semantic_centers", "mask_points_coords",
                "loss_mil"):
        assert bool(torch.isfinite(out[key].float()).all()), f"{key} not finite"
    b = out["pseudo_gt_bboxes"][0, :n_valid]
    assert bool(((b[:, 0] >= 0) & (b[:, 2] <= w) & (b[:, 1] >= 0) & (b[:, 3] <= h)).all())
    assert set(out["pseudo_gt_masks"].unique().tolist()) <= {0, 1}
    assert set(out["mask_points_labels"].unique().tolist()) <= {0, 1, 2}
    assert bool((out["mask_points_labels"][0, n_valid:] == 2).all()), "padding labels must be 2"
    assert bool((out["pseudo_gt_masks"][0, n_valid:] == 0).all()), "padded masks must be empty"
    assert bool(((out["best_attn_idx"] >= 0) & (out["best_attn_idx"] < CAM_LAYERS)).all())


def phase_small_reference(dev):
    """The slice on the card (bf16, kernels) against the plain path on the
    CPU (f32) at a small input with the same weights and draws: the
    backbone within bf16 tolerance, every pseudo-label output of the
    expected shape, finite, and the agreement printed."""
    import torch

    h, w, g, nv = 128, 192, 4, 3
    gpu = build_model(dev, torch.bfloat16, max_gt=g)
    cpu = build_model("cpu", torch.float32, max_gt=g)
    inp_cpu = slice_inputs(h, w, g, nv, "cpu")
    inp_gpu = tuple(t.to(dev) for t in inp_cpu)
    with torch.no_grad():
        bg = gpu.backbone(inp_gpu[0])
        bc = cpu.backbone(inp_cpu[0])
    for key, rel in (("attns", 2e-2), ("last_feat", 5e-2), ("outputs_class", 5e-2),
                     ("outputs_coord", 2e-2)):
        ref = bc[key].float()
        err = max_err(bg[key].cpu(), ref)
        expect(f"small.backbone.{key}", err, rel * max(float(ref.abs().max()), 1e-6),
               "bf16 card path vs f32 CPU path through 12 blocks: relative to the largest value")
    gen = torch.Generator().manual_seed(0)
    n_map = (h // 4) * (w // 4)
    draws = [dict(points_fg=torch.rand((g + 1, 20, 2), generator=gen) * torch.tensor([w, h]),
                  points_bg=torch.rand((g, 20, 2), generator=gen) * torch.tensor([w, h]),
                  gumbel=-torch.log(-torch.log(torch.rand((g, n_map), generator=gen))))]
    og = gpu.seed_pseudo_gt(*inp_gpu, draws=[{k: v.to(dev) for k, v in draws[0].items()}])
    oc = cpu.seed_pseudo_gt(*inp_cpu, draws=draws)
    sync()
    check_outputs(og, h, w, g, nv)
    check_outputs(oc, h, w, g, nv)
    agree = float((og["best_attn_idx"].cpu() == oc["best_attn_idx"]).float().mean())
    dmap = float((og["map_cos_fg"].cpu().float() - oc["map_cos_fg"]).abs().mean())
    log(f"[small] card bf16 vs CPU f32: best layer agreement {agree:.3f}, "
        f"mean |map_cos_fg| difference {dmap:.4f} (reported, not asserted)")
    # inference on both: the box head's scores and decoded boxes on the same
    # rois within bf16 tolerance, every output of simple_test well-formed
    rois = torch.tensor([[[8.0, 8.0, 120.0, 100.0], [40.0, 20.0, 180.0, 90.0],
                          [0.0, 0.0, 64.0, 64.0]]])
    sg, bg = gpu.roi_test(inp_gpu[0], rois.to(dev), inp_gpu[4])
    sc, bc = cpu.roi_test(inp_cpu[0], rois, inp_cpu[4])
    expect("small.roi_test.scores", max_err(sg.cpu(), sc), 2e-2,
           "softmax scores, bf16 card path vs f32 CPU path")
    expect("small.roi_test.boxes", max_err(bg.cpu(), bc), 2e-2 * w,
           "decoded boxes in pixels, relative to the image width")
    for m in (gpu, cpu):
        m.test_score_thr = INFER_SCORE_THR
    tg = gpu.simple_test(inp_gpu[0], inp_gpu[4])
    tc = cpu.simple_test(inp_cpu[0], inp_cpu[4])
    sync()
    ng = check_test_outputs(tg, gpu.test_max_per_img, (w, h))
    nc = check_test_outputs(tc, cpu.test_max_per_img, (w, h))
    log(f"[small] simple_test: {ng} valid detections on the card, {nc} on the CPU "
        f"(reported, not asserted: bf16 moves near-tied scores across the NMS)")


def expected_launches(**counts) -> dict:
    """Every kernel's expected count of one path: 0 unless named."""
    from attentionshift_torch.ops._build import KERNELS

    return {name: counts.get(name, 0) for name in KERNELS}


def recording(module, name: str, store: dict):
    """Patch ``module.name`` with a pass-through that keeps a copy of the
    arguments of its last call in ``store[name]``."""
    from unittest import mock

    import torch

    fn = getattr(module, name)

    def record(*args, **kwargs):
        store[name] = ([a.clone() if torch.is_tensor(a) else a for a in args], dict(kwargs))
        return fn(*args, **kwargs)

    return mock.patch.object(module, name, record)


def phase_main_path(dev):
    """seed_pseudo_gt at the bench geometry; launch counts of that run, and
    the inputs it handed the CCL and mean-shift kernels."""
    import torch

    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.pseudo import engine, meanshift

    model = build_model(dev, torch.bfloat16)
    inp = slice_inputs(H_IMG, W_IMG, MAX_GT, N_VALID, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    handed: dict = {}
    with recording(engine, "connected_components_batch", handed), \
            recording(meanshift, "cosine_shift_fixpoint", handed):
        reset_launches()
        out = model.seed_pseudo_gt(*inp, generator=gen)
        sync()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"[main] launches per image: {launches}")
    want = expected_launches(attention_capture=CAM_LAYERS, attention_plain=12 - CAM_LAYERS,
                             ccl_batch=1, meanshift_fixpoint=1)
    if launches != want:
        raise AssertionError(f"main path launches {launches} != {want}")
    check_outputs(out, H_IMG, W_IMG, MAX_GT, N_VALID)
    nvalid_parts = int(out["semantic_centers_valid"].sum())
    log(f"[main] outputs ok: boxes {out['pseudo_gt_bboxes'][0, :N_VALID].tolist()}, "
        f"valid semantic centers {nvalid_parts}, loss_mil {float(out['loss_mil']):.4f}")
    return model, inp, gen, launches, handed


LOSS_KEYS = {"loss_mil", "loss_rpn_cls", "loss_rpn_bbox", "loss_point_cls", "loss_point",
             "pos_point_acc", "loss_cls", "loss_bbox", "acc", "loss_mask"}
SUBMODULES = ("backbone", "neck", "rpn_head", "mil_head", "bbox_head", "mask_head")
TRAIN_STEPS = 3
# per train step: the forward's 7 capture + 5 plain blocks, the checkpoint
# recompute of all 12 blocks through the plain kernel (the captured matrix
# is not needed again), one backward pair per block, CCL and mean-shift
TRAIN_LAUNCHES = {"attention_capture": CAM_LAYERS, "attention_plain": (12 - CAM_LAYERS) + 12,
                  "attention_bwd_dq": 12, "attention_bwd_dkv": 12, "ccl_batch": 1,
                  "meanshift_fixpoint": 1}


def phase_train_path(dev, model, inp):
    """Three full-width bf16 train steps; launch counts of that run."""
    import torch

    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step

    if not (model.backbone.use_remat and model.backbone.drop_path_rate > 0):
        raise AssertionError("the train path runs with checkpointing and drop path on")
    opt = build_optimizer(model, base_lr=1e-4, steps_per_epoch=100, accumulate_steps=1, depth=12)
    state = TrainState.create(model, opt)
    step_fn = make_train_step(model)
    batch = dict(zip(("img", "gt_points", "gt_labels", "gt_valid", "img_wh"), inp))
    gen = torch.Generator(device=dev).manual_seed(1)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grad_top = {m: 0.0 for m in SUBMODULES}
    inner = opt.step

    def spy(grads):
        for name, g in zip(opt.names, grads):
            if g is not None:
                m = name.split(".", 1)[0]
                grad_top[m] = max(grad_top[m], float(g.float().abs().max()))
        return inner(grads)

    opt.step = spy
    reset_launches()
    for i in range(TRAIN_STEPS):
        state, metrics = step_fn(state, batch, generator=gen)
        sync()
        vals = {k: float(v) for k, v in metrics.items()}
        log(f"[train] step {i + 1}: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(vals.items())))
        if set(vals) != LOSS_KEYS | {"loss_total"}:
            raise AssertionError(f"train step loss keys {sorted(vals)}")
        bad = [k for k, v in vals.items() if v != v or abs(v) == float("inf")]
        if bad:
            raise AssertionError(f"train step {i + 1}: non-finite {bad}")
    launches = {name: k.launches for name, k in KERNELS.items()}
    opt.step = inner
    log(f"[train] launches over {TRAIN_STEPS} steps: {launches}")
    want = expected_launches(**{k: TRAIN_STEPS * v for k, v in TRAIN_LAUNCHES.items()})
    if launches != want:
        raise AssertionError(f"train path launches {launches} != {want}")
    log(f"[train] largest |gradient| per submodule: {grad_top}")
    dead = [m for m, v in grad_top.items() if not v > 0]
    if dead:
        raise AssertionError(f"no gradient reached {dead}")
    if state.step != TRAIN_STEPS or opt.count != TRAIN_STEPS or opt.total_notfinite:
        raise AssertionError(f"step counters: {state.step}, {opt.count}, {opt.total_notfinite}")
    moved = {m: 0 for m in SUBMODULES}
    for n, p in model.named_parameters():
        moved[n.split(".", 1)[0]] += int(not torch.equal(p.detach(), before[n]))
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"parameter {n} is not finite after the steps")
    log(f"[train] parameter tensors changed per submodule: {moved}")
    if not all(moved.values()):
        raise AssertionError(f"parameters did not change: {moved}")
    return state, step_fn, batch, gen, launches


# true extent smaller than the 800x1344 canvas, so that the clip binds
INFER_WH = (1300.0, 760.0)
# seeded random heads score every class near 1/21 = 0.048, around the config's
# floor of 0.05: how many detections the configured call keeps is up to the
# weights, so a second call with a lower floor is sure to hold detections to
# check; the floor is put back, and every timed call runs as configured
INFER_SCORE_THR = 0.02
TOOL_ITERS, TOOL_INNER = 12, 10


def check_test_outputs(out, k: int, wh) -> int:
    import torch

    d = out.dets
    shapes = dict(boxes=(1, k, 4), scores=(1, k), labels=(1, k), valid=(1, k))
    for key, shape in shapes.items():
        assert tuple(getattr(d, key).shape) == shape, (key, tuple(getattr(d, key).shape))
    assert tuple(out.mask_probs.shape) == (1, k, 28, 28), tuple(out.mask_probs.shape)
    assert d.labels.dtype == torch.int32 and d.valid.dtype == torch.bool
    for key, t in (("boxes", d.boxes), ("scores", d.scores), ("mask_probs", out.mask_probs)):
        assert bool(torch.isfinite(t.float()).all()), f"{key} not finite"
    b = d.boxes[0].float()
    assert bool(((b >= 0).all() and (b[:, 0::2] <= wh[0]).all() and (b[:, 1::2] <= wh[1]).all()))
    assert bool((b[:, 2] >= b[:, 0]).all() and (b[:, 3] >= b[:, 1]).all())
    assert bool(((out.mask_probs >= 0) & (out.mask_probs <= 1)).all())
    assert bool(((d.labels >= 0) & (d.labels < 20)).all())
    n = int(d.valid.sum())
    assert bool((d.scores[0, :n] > 0).all()) and bool((d.scores[0, n:] == 0).all())
    assert bool((d.scores[0, :max(n - 1, 0)] >= d.scores[0, 1:max(n, 1)]).all()), "score order"
    return n


def phase_infer_path(dev, model, slice_inp):
    """``simple_test`` through ``make_eval_step`` at the bench geometry;
    launch counts of that run."""
    import torch

    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.train import make_eval_step

    if (model.num_proposals, model.test_max_per_img) != (1000, 100):
        raise AssertionError("inference runs at the config's 1000 proposals / 100 detections")
    img = slice_inp[0]
    wh = torch.tensor([INFER_WH], device=dev)
    eval_step = make_eval_step(model)
    reset_launches()
    out = eval_step(img, wh)
    sync()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"[infer] launches per image: {launches}")
    if launches != expected_launches(attention_plain=12):
        raise AssertionError(f"inference launches {launches}: expected 12 plain and nothing else")
    n_cfg = check_test_outputs(out, model.test_max_per_img, INFER_WH)
    configured = model.test_score_thr
    model.test_score_thr = INFER_SCORE_THR
    try:
        low = eval_step(img, wh)
        sync()
    finally:
        model.test_score_thr = configured
    n = check_test_outputs(low, model.test_max_per_img, INFER_WH)
    if n == 0:
        raise AssertionError("inference kept no detection at the lowered floor: nothing to check")
    log(f"[infer] outputs ok: {n_cfg} of {model.test_max_per_img} slots valid at the config's score "
        f"floor {configured}; at floor {INFER_SCORE_THR}: {n} valid, top score "
        f"{float(low.dets.scores[0, 0]):.4f}, first box "
        f"{[round(x, 1) for x in low.dets.boxes[0, 0].tolist()]}, true extent {INFER_WH}")
    return eval_step, img, wh, launches


def phase_infer_times(model, eval_step, img, wh):
    """ms/img of inference as configured (host clock over calls ending in
    synchronize), then one profiled call."""

    def run():
        eval_step(img, wh)

    run()
    sync()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    ms_img = (time.perf_counter() - t0) / reps * 1e3
    log(f"[time] simple_test at {H_IMG}x{W_IMG}, batch 1, bf16, ViT-S, 1000 proposals, 100 "
        f"detections, score floor {model.test_score_thr} (the config's): {ms_img:.2f} ms/img "
        f"(host clock over {reps} calls ending in synchronize)")
    profile_slice(run, ms_img, what="inference call")
    return ms_img


def phase_tool(dev):
    """The attention microbenchmark at its defaults, every variant."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.ops.attention_variants import VARIANTS
    from attentionshift_torch.tools.analysis import microbench_attention as tool

    reset_launches()
    res = tool.run_variants(device=dev, inner=TOOL_INNER, iters=TOOL_ITERS,
                            log=lambda line: log(f"[tool] {line}"))
    sync()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"[tool] {({k: round(v, 3) for k, v in sorted(res.items(), key=lambda x: x[1])})}")
    log(f"[tool] launches: {launches}")
    if list(res) != list(tool.VARIANT_NAMES):
        raise AssertionError(f"the tool ran {list(res)}")
    per_name = (TOOL_ITERS + 1) * TOOL_INNER  # one warm-up chain, then the timed ones
    want = expected_launches(attention_capture=per_name, attention_plain=per_name,
                             **{kernel: per_name for kernel, _ in VARIANTS.values()})
    if launches != want:
        raise AssertionError(f"tool launches {launches} != {want}")
    bad = [n for n, ms in res.items() if not (ms == ms and 0 < ms < float("inf"))]
    if bad:
        raise AssertionError(f"the tool gave no finite time for {bad}")
    return launches


def phase_train_times(state, step_fn, batch, gen):
    """ms per train step (host clock over steps ending in synchronize),
    then one profiled step: device busy share and peak device memory."""
    import torch

    def run():
        step_fn(state, batch, generator=gen)

    reps = 3
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    ms_step = (time.perf_counter() - t0) / reps * 1e3
    log(f"[time] train step at {H_IMG}x{W_IMG}, batch 1, bf16, ViT-S, checkpointing on: "
        f"{ms_step:.2f} ms/step (host clock over {reps} steps ending in synchronize)")
    torch.cuda.reset_peak_memory_stats()
    profile_slice(run, ms_step, what="train step")
    log(f"[time] train step peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB allocated")
    return ms_step


def phase_times(results: dict, inp: dict, model, slice_inp, gen):
    """CUDA-event times of every kernel, its plain version and the library
    call; bounds from the bytes and operations of these inputs."""
    import torch
    import torch.nn.functional as F

    from attentionshift_torch.ops import attention, attention_variants, ccl, meanshift_kernel

    q, k, v = inp["qkv"]
    b, h, t, d = q.shape
    qkv_bytes = 3 * q.numel() * 2
    attn_flops = 4.0 * b * h * t * t * d
    bias = torch.zeros((1, 1, 1, t), device=q.device, dtype=q.dtype)
    bias[..., PAD_GAP[0]:PAD_GAP[1]] = float("-inf")
    # the attention kernels and their SDPA yardsticks are read in turns
    # (kernel, library, library, kernel, ...): medians of 6 readings each
    (plain_ms, sdpa_fwd), (plain_reads, sdpa_reads) = in_turns(
        lambda: attention.attention_no_capture(q, k, v, PAD_GAP),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
    out, lse = attention.flash_forward(q, k, v, PAD_GAP, with_lse=True)
    mean_ms = median_time(lambda: attention._mean(q, k, lse, PAD_GAP))
    times = {
        "attention_capture": dict(
            ms=median_time(lambda: attention.attention_with_capture(q, k, v, PAD_GAP)),
            plain_ms=cuda_time(lambda: attention.attention_reference(q, k, v, PAD_GAP), reps=3),
            library_ms=None,
            bytes=qkv_bytes + q.numel() * 2 + b * t * t * 2, ops=attn_flops, peak=PEAK_BF16,
            exps=2.0 * b * h * t * t),
        "attention_plain": dict(
            ms=plain_ms,
            plain_ms=cuda_time(lambda: attention.attention_reference(q, k, v, PAD_GAP)[0], reps=3),
            library_ms=sdpa_fwd, bytes=qkv_bytes + q.numel() * 2, ops=attn_flops, peak=PEAK_BF16,
            exps=1.0 * b * h * t * t),
    }
    # the exp floor: one exp2 per (head, row, key) per pass at the SM clock
    # nvidia-smi reads while the flash pass runs
    clk, clk_max = sm_clock_under_load(lambda: attention.flash_forward(q, k, v, PAD_GAP, False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = EXP2_PER_CLOCK_PER_SM * sms * clk * 1e6  # exp2 per second
    for name in ("attention_plain", "attention_capture"):
        times[name]["exp_floor_ms"] = times[name]["exps"] / exp_rate * 1e3
    log(f"[time] SM clock under the flash pass {clk:.0f} MHz (max {clk_max:.0f}), {sms} SMs: "
        f"exp floor = B*H*T^2 exp2 at {EXP2_PER_CLOCK_PER_SM} per clock per SM")
    log(f"[time] flash_fwd (attention_plain): {plain_ms:.4f} ms = "
        f"{attn_flops / (plain_ms * 1e-3) / 1e12:.1f} TFLOP/s = {plain_ms / sdpa_fwd:.2f}x SDPA's "
        f"forward with the same mask ({sdpa_fwd:.4f} ms); readings in turns: kernel "
        f"{[round(x, 4) for x in plain_reads]}, SDPA {[round(x, 4) for x in sdpa_reads]}")
    results["attention_capture"]["mean_pass_ms"] = mean_ms
    mean_floor = b * h * t * t / exp_rate * 1e3
    mean_bound = max(b * t * t * 2 / PEAK_BYTES, 2.0 * b * h * t * t * d / PEAK_BF16) * 1e3
    log(f"[time] mean pass (attn_mean alone): {mean_ms:.4f} ms (median of 5), bound "
        f"{mean_bound:.4f} ms, exp floor {mean_floor:.4f} ms; capture = flash + mean pass")
    g = inp["g_out"]
    _, dd = attention.attention_backward_dq(q, k, v, out, lse, g, PAD_GAP)
    # one plain backward computes all three gradients: its time stands beside
    # both kernels; so does the library's, the backward of SDPA with the mask,
    # read in turns with the pair
    plain_bwd = cuda_time(lambda: attention.attention_backward_reference(q, k, v, g, PAD_GAP),
                          reps=3)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)

    def pair():
        attention.attention_backward_dq(q, k, v, out, lse, g, PAD_GAP)
        attention.attention_backward_dkv(q, k, v, lse, dd, g, PAD_GAP)

    (pair_ms, lib_bwd), (pair_reads, lib_reads) = in_turns(
        pair, lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    del sdpa_out, leaves
    stat_bytes = 2 * b * h * t * 4  # the row statistic and D, f32
    times["attention_bwd_dq"] = dict(
        ms=median_time(lambda: attention.attention_backward_dq(q, k, v, out, lse, g, PAD_GAP)),
        plain_ms=plain_bwd, library_ms=lib_bwd,
        bytes=6 * q.numel() * 2 + stat_bytes, ops=6.0 * b * h * t * t * d, peak=PEAK_BF16)
    times["attention_bwd_dkv"] = dict(
        ms=median_time(lambda: attention.attention_backward_dkv(q, k, v, lse, dd, g, PAD_GAP)),
        plain_ms=plain_bwd, library_ms=lib_bwd,
        bytes=6 * q.numel() * 2 + stat_bytes, ops=8.0 * b * h * t * t * d, peak=PEAK_BF16)
    # the variants at the microbenchmark's own shape (T = 4301, no gap); the
    # library call beside them computes `out`, not the mean
    tq, tk, tv = inp["tool_qkv"]
    tt = tq.shape[2]
    sdpa_no_gap = cuda_time(lambda: F.scaled_dot_product_attention(tq, tk, tv))
    for name, (kernel, _) in attention_variants.VARIANTS.items():
        # v6's product has 72 columns: its bound counts its own 8 columns of ones
        pv_cols = d + 8 if name == "v6-fusedsum" else d
        times[kernel] = dict(
            ms=cuda_time(lambda n=name: attention_variants.attention_variant(tq, tk, tv, n)),
            plain_ms=cuda_time(lambda n=name: attention_variants.variant_reference(tq, tk, tv, n),
                               reps=3),
            library_ms=sdpa_no_gap,
            bytes=4 * tq.numel() * 2 + b * tt * tt * 2,
            ops=2.0 * b * h * tt * tt * (d + pv_cols), peak=PEAK_BF16)
    masks = inp["masks"]
    # the sweeps each plane runs to its fixpoint: the data-dependent work
    sweeps = ccl.connected_components(masks, 64, return_sweeps=True)[1].tolist()
    cells = masks.shape[1] * masks.shape[2]
    # per sweep and cell: 9-cell minimum + 2 run scans x 2 directions (int32)
    results["ccl_batch"]["inputs"] = (masks, 64)
    times["ccl_batch"] = dict(
        ms=cuda_time(lambda: ccl.connected_components_batch(masks, 64)),
        plain_ms=cuda_time(lambda: ccl.connected_components(masks, 64), reps=2, warmup=1),
        library_ms=None, bytes=masks.numel() * (1 + 4), ops=float(sum(sweeps)) * cells * 13,
        peak=PEAK_F32)
    log(f"[time] ccl sweeps per plane: max {max(sweeps)}, total {sum(sweeps)} over {len(sweeps)} planes")
    prot0, mask, f = inp["prot0"], inp["mask"], inp["f"]
    g, kk, dd = prot0.shape
    n = f.shape[0]
    results["meanshift_fixpoint"]["inputs"] = (prot0, mask, f, 0.1, 0.1, 10, torch.bfloat16)
    times["meanshift_fixpoint"] = dict(
        ms=cuda_time(lambda: meanshift_kernel.cosine_shift_fixpoint(
            prot0, mask, f, n_shift=10, matmul_dtype=torch.bfloat16), reps=5),
        plain_ms=cuda_time(lambda: meanshift_kernel.cosine_shift_batch(
            prot0, f[None] * mask[..., None], f, n_shift=10, matmul_dtype=torch.bfloat16), reps=3),
        library_ms=None,
        bytes=4 * (prot0.numel() + mask.numel() + f.numel() + prot0.numel() + g * kk * n),
        ops=g * (11 * 2.0 * kk * n * dd + 10 * 2.0 * n * dd), peak=PEAK_BF16)
    for name in ("attention_bwd_dq", "attention_bwd_dkv"):
        tm = times[name]
        log(f"[time] {name}: {tm['ops'] / (tm['ms'] * 1e-3) / 1e12:.1f} TFLOP/s achieved "
            f"({tm['ops'] / 1e9:.1f} GFLOP of its products at the bench shape)")
    log(f"[time] backward pair {pair_ms:.4f} ms = {pair_ms / lib_bwd:.2f}x SDPA's backward "
        f"({lib_bwd:.4f} ms, same mask); readings in turns: pair "
        f"{[round(x, 4) for x in pair_reads]}, SDPA {[round(x, 4) for x in lib_reads]}")
    for name, tm in times.items():
        t_bytes = tm["bytes"] / PEAK_BYTES * 1e3
        t_ops = tm["ops"] / tm["peak"] * 1e3
        results[name].update(
            ms=tm["ms"], plain_ms=tm["plain_ms"], library_ms=tm["library_ms"],
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        floor = f", exp floor {tm['exp_floor_ms']:.4f} ms" if "exp_floor_ms" in tm else ""
        log(f"[time] {name}: kernel {tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, library "
            f"{tm['library_ms'] if tm['library_ms'] is None else round(tm['library_ms'], 4)} ms, "
            f"bound {results[name]['bound_ms']:.4f} ms ({results[name]['bound_by']}){floor}")

    def run():
        model.seed_pseudo_gt(*slice_inp, generator=gen)

    run()
    sync()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    ms_img = (time.perf_counter() - t0) / reps * 1e3
    log(f"[time] seed_pseudo_gt at {H_IMG}x{W_IMG}, bf16, ViT-S: {ms_img:.2f} ms/img "
        f"(host clock over {reps} calls ending in synchronize)")
    profile_slice(run, ms_img)
    return ms_img


def phase_main_path_inputs(results: dict, handed: dict) -> None:
    """CCL and mean-shift on the inputs ``seed_pseudo_gt`` handed them
    (phase 4), timed in turns with the same kernels on phase 3's synthetic
    inputs; the per-plane sweeps and the mask fill of those inputs, the
    mean-shift launch plan and how many clusters the card holds at once."""
    import torch

    from attentionshift_torch.ops import ccl, meanshift_kernel

    (masks, *rest), kw = handed["connected_components_batch"]
    iters = kw.get("max_iters", rest[0] if rest else 256)
    sweeps = ccl.connected_components(masks, iters, return_sweeps=True)[1].tolist()
    log(f"[main-input] ccl: planes {tuple(masks.shape)}, max_iters {iters}, foreground "
        f"{float(masks.float().mean()):.3f}, sweeps per plane: max {max(sweeps)}, total "
        f"{sum(sweeps)} over {len(sweeps)} planes, histogram "
        f"{sorted(collections.Counter(sweeps).items())}")
    margs, mkw = handed["cosine_shift_fixpoint"]
    prot0, box_mask, f = margs[:3]
    g, k, d = prot0.shape
    n = f.shape[0]
    bf16 = mkw.get("matmul_dtype") == torch.bfloat16
    (c, tb, stages, smem), active = meanshift_kernel.launch_plan(g, k, n, d, bf16, f.device)
    kp, tiles = -(-k // 8) * 8, -(-n // 64)
    fits = {}
    for cc in meanshift_kernel._CLUSTERS:  # at the most ring slots that fit
        for st in range(meanshift_kernel._MAX_STAGES, 0, -1):
            cc_smem = meanshift_kernel._smem_bytes(kp, bf16, d, -(-tiles // cc), st)
            if cc_smem <= meanshift_kernel._SMEM_LIMIT:
                fits[cc] = active(cc, cc_smem)
                break
    log(f"[main-input] meanshift: G {g}, K {k}, N {n}, D {d}, bf16 {bf16}, n_shift "
        f"{mkw.get('n_shift')}, box-mask cells per instance {box_mask.sum(1).int().tolist()}; "
        f"plan: clusters of {c} blocks, {tb} tiles of 64 features per block, {stages} ring "
        f"slots, {smem} B of shared memory; cudaOccupancyMaxActiveClusters per cluster size "
        f"{fits}: {g} instances in {-(-g // active(c, smem))} wave(s)")
    syn = results["meanshift_fixpoint"], results["ccl_batch"]
    (ms_main, ms_syn, ccl_main, ccl_syn), _ = in_turns(
        lambda: meanshift_kernel.cosine_shift_fixpoint(*margs, **mkw),
        lambda: meanshift_kernel.cosine_shift_fixpoint(*syn[0]["inputs"]),
        lambda: ccl.connected_components_batch(masks, iters),
        lambda: ccl.connected_components_batch(*syn[1]["inputs"]))
    cells = masks.shape[1] * masks.shape[2]
    ccl_bound = max(masks.numel() * 5 / PEAK_BYTES, sum(sweeps) * cells * 13 / PEAK_F32) * 1e3
    results["meanshift_fixpoint"]["ms_main_path_input"] = ms_main
    results["ccl_batch"]["ms_main_path_input"] = ccl_main
    log(f"[main-input] meanshift_fixpoint: {ms_main:.4f} ms on the main path's input, "
        f"{ms_syn:.4f} ms on phase 3's (medians of 6 in turns)")
    log(f"[main-input] ccl_batch: {ccl_main:.4f} ms on the main path's input (bound "
        f"{ccl_bound:.4f} ms), {ccl_syn:.4f} ms on phase 3's (medians of 6 in turns)")


def profile_slice(run, ms_img: float, top: int = 12, what: str = "call") -> None:
    """Where one call's time goes: device time by kernel (torch.profiler;
    the ``top`` kernels and every hand-written one) and the device's busy
    share of the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        log("[profile] device time: not measured (the profiler recorded no device events)")
        return
    log(f"[profile] one {what}: wall {wall_ms:.2f} ms (unprofiled {ms_img:.2f}), device busy "
        f"{dev_ms:.2f} ms = {dev_ms / wall_ms:.1%} of wall, {len(events)} kernel names")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top kernels, then every hand-written one (csrc/ kernels live in
    # anonymous namespaces) that the top list left out
    shown = ranked[:top] + [e for e in ranked[top:] if "(anonymous namespace)::" in e.key]
    for e in shown:
        log(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def phase_ablation(sources) -> None:
    """Design constants: each source of ``ABLATIONS`` built once per
    variant (all builds started together), each variant checked against
    the plain version at the bench shape (limits of phase 3), then read in
    turns: the forward pair's flash pass beside SDPA's forward with the
    same mask and its mean pass; the mean-shift fixpoint (bf16) and CCL on
    phase 3's inputs."""
    import torch
    import torch.nn.functional as F

    from attentionshift_torch.ops import _build, attention, ccl, meanshift_kernel

    unknown = [s for s in sources if s not in ABLATIONS]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown sources {unknown}; known: {list(ABLATIONS)}")
    phase_build([(src, d) for src in sources for d in ABLATIONS[src].values()])
    dev = torch.device("cuda")
    fns = {}
    if "attention" in sources:
        libs = {n: attention.forward_library(d) for n, d in ABLATIONS["attention"].items()}
        q, k, v = bench_qkv(dev, torch.Generator(device=dev).manual_seed(0))
        ref_out, ref_mean = attention.attention_reference(q, k, v, PAD_GAP)
        for n, lib in libs.items():
            out, lse = attention.flash_forward(q, k, v, PAD_GAP, True, lib=lib)
            mean = attention._mean(q, k, lse, PAD_GAP, lib=lib)
            sync()
            expect(f"attention, {n}: out", max_err(out, ref_out), bf16_ulps(ref_out, 4),
                   "4 bf16 ulps of the largest |out|")
            expect(f"attention, {n}: mean", max_err(mean, ref_mean),
                   2e-3 * float(ref_mean.float().abs().max()),
                   "bf16 storage of the mean: 2^-9 relative, times the largest entry")
        del ref_out, ref_mean, out, mean
        _, lse = attention.flash_forward(q, k, v, PAD_GAP, True)
        bias = torch.zeros((1, 1, 1, q.shape[2]), device=dev, dtype=q.dtype)
        bias[..., PAD_GAP[0]:PAD_GAP[1]] = float("-inf")
        fns.update({f"flash, {n}": (lambda lib=lib: attention.flash_forward(q, k, v, PAD_GAP, False,
                                                                             lib=lib))
                    for n, lib in libs.items()})
        fns["flash, SDPA forward"] = lambda: F.scaled_dot_product_attention(q, k, v,
                                                                          attn_mask=bias)
        fns.update({f"mean pass, {n}": (lambda lib=lib: attention._mean(q, k, lse, PAD_GAP,
                                                                        lib=lib))
                    for n, lib in libs.items()})
    if "meanshift" in sources or "ccl" in sources:
        inp = kernel_inputs(dev, torch.Generator(device=dev).manual_seed(0))
    if "meanshift" in sources:
        prot0, mask, f = inp["prot0"], inp["mask"], inp["f"]
        ref_p, ref_s = meanshift_kernel.cosine_shift_batch(
            prot0, f[None] * mask[..., None], f, n_shift=10, matmul_dtype=torch.bfloat16)
        for n, d in ABLATIONS["meanshift"].items():
            lib = _build.library("meanshift", d)
            got_p, got_s = meanshift_kernel.cosine_shift_fixpoint(
                prot0, mask, f, n_shift=10, matmul_dtype=torch.bfloat16, lib=lib)
            sync()
            expect(f"meanshift, {n}: prototypes(rel)",
                   max_err(got_p, ref_p) / float(ref_p.abs().max()), 2e-3, "bf16 dot operands")
            expect(f"meanshift, {n}: sim", max_err(got_s, ref_s), 2e-3, "bf16 dot operands")
            fns[f"meanshift, {n}"] = lambda lib=lib: meanshift_kernel.cosine_shift_fixpoint(
                prot0, mask, f, n_shift=10, matmul_dtype=torch.bfloat16, lib=lib)
    if "ccl" in sources:
        masks = inp["masks"]
        ref_lab = ccl.connected_components(masks, 64)
        for n, d in ABLATIONS["ccl"].items():
            lib = _build.library("ccl", d)
            expect(f"ccl, {n}", max_err(ccl.connected_components_batch(masks, 64, lib=lib),
                                        ref_lab), 0.0, "integer labels: exact")
            fns[f"ccl, {n}"] = lambda lib=lib: ccl.connected_components_batch(masks, 64, lib=lib)
    meds, reads = in_turns(*fns.values(), reps=20)
    for name, med, got in zip(fns, meds, reads):
        rate = ""
        if name.startswith("flash"):
            rate = f" = {4.0 * q.numel() * q.shape[2] / (med * 1e-3) / 1e12:.1f} TFLOP/s"
        log(f"[ablate] {name}: {med:.4f} ms{rate} (median of {len(got)} readings in turns: "
            f"{[round(x, 4) for x in got]})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", nargs="*", metavar="SOURCE",
                    help="only the ablation of design constants, every variant of each source "
                         "of ABLATIONS (default: all sources)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not os.path.isdir(os.path.join(HERE, "attentionshift_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    import torch

    from attentionshift_torch.ops._build import KERNELS

    smi = phase_card()
    if args.ablate is not None:
        phase_ablation(args.ablate or list(ABLATIONS))
        log(smi)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    results: dict = {}
    inp = kernel_inputs(dev, torch.Generator(device=dev).manual_seed(0))
    phase_kernels(results, inp)
    phase_small_reference(dev)
    model, slice_inp, gen, seed_launches, handed = phase_main_path(dev)
    eval_step, infer_img, infer_wh, infer_launches = phase_infer_path(dev, model, slice_inp)
    state, step_fn, batch, train_gen, train_launches = phase_train_path(dev, model, slice_inp)
    tool_launches = phase_tool(dev)
    phase_times(results, inp, model, slice_inp, gen)
    phase_main_path_inputs(results, handed)
    phase_train_times(state, step_fn, batch, train_gen)
    phase_infer_times(model, eval_step, infer_img, infer_wh)
    table = []
    for name, kern in KERNELS.items():
        r = results[name]
        # launches: each path was driven with the counts at 0 and read right after
        table.append(dict(name=name, route="cuda", source=f"attentionshift_torch/csrc/{kern.source}.cu",
                          replaces=kern.replaces,
                          launches=(seed_launches[name] + infer_launches[name]
                                    + train_launches[name] + tool_launches[name]),
                          launches_seed_pseudo_gt=seed_launches[name],
                          launches_simple_test=infer_launches[name],
                          launches_train_steps=train_launches[name],
                          launches_microbench_tool=tool_launches[name],
                          max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                          bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"],
                          **{key: r[key] for key in ("mean_pass_ms", "ms_main_path_input")
                             if key in r}))
    log(smi)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
