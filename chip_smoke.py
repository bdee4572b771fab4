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
8. the evaluation entry point: the twin of ``tools/test.py``
   (``attentionshift_torch.tools.test.main``) in this process, on a
   synthetic VOC2012 tree of two VOC-size images (500x375 and 375x500, 2-3
   blob instances each) in a temporary directory, from a ``save_params``
   export of the seeded ViT-S model of ``configs/attnshift_voc12aug.py``:
   single-scale and aug-test (6 scales x flip), each as configured and
   once more with a lowered score floor. The metric keys mAP@{0.25, 0.5,
   0.75}, finite; the port's maskapi library built (``native_available()``);
   exactly 12 / 432 ``flash_fwd`` launches per image and no other kernel;
   detections on every image at the lowered floor and masks pasted at the
   images' sizes (their pixels over 0.5 reported); the token counts T the
   backbone met;
9. the training entry point: the twin of ``tools/train.py``
   (``attentionshift_torch.tools.train.main``) in this process on the
   config as it is (batch 2, accumulate_steps 2, 11 train scales) over a
   synthetic VOC point tree of 8 landscape VOC-size images, with a
   synthetic MAE ViT-S checkpoint: the graft checked tensor by tensor
   before the first step; invocation 1 runs 4 micro-steps, saves
   ``epoch_1`` and evaluates 2 val images; invocation 2, under a
   world-size-1 NCCL process group, auto-resumes from ``epoch_1``, runs 4
   micro-steps, saves ``epoch_2`` and evaluates. Exactly 7/17/12/12/2/2
   launches per micro-step and 24 ``flash_fwd`` per evaluation; finite
   losses with the expected keys and ``train_log.jsonl``; a gradient in
   every submodule and every submodule moved; ``opt.count`` 2 after 4
   micro-steps; the group's all-reduces counted; invocation 2's first step
   run again without a group gives the same losses (bf16 tolerance);
10. the pseudo-label dump: the twin of ``tools/gen_pseudo_labels.py`` on
   ``epoch_2`` over the 8 train images at (800, 1333): exactly 7/5/1/1
   launches per image and no backward kernel, every RLE decoded at its
   image's size with its area, boxes inside their images, category ids in
   1..20;
11. times with CUDA events: every kernel, its plain version, the library
   call where one exists, ms/img of the pseudo-label path and of
   inference and ms per train step, each with one profiled call. The
   attention kernels and their SDPA yardsticks (the forward with the same
   mask; the backward of it beside the backward pair) are read in turns,
   kernel, library, library, kernel, ..., and each reports the median of
   its readings; the flash pass's and the backward pair's TFLOP/s and
   ratio to SDPA, the mean pass's own time, and an exp floor (B*H*T^2
   exp2 per pass at 16 per clock per SM, at the SM clock nvidia-smi reads
   while the flash pass runs) beside the forward bounds. For the eval
   path: ``flash_fwd`` against its plain version at every T it met,
   (1, 6, T, 64) bf16 without a gap (4 bf16 ulps, with a control that
   drops the last 64 keys), timed in turns with SDPA's forward at each T
   beside its bound; ms/img of single-scale and aug-test evaluation (host
   clock over the images), and one profiled image of each: device busy
   share, ``cudaStreamSynchronize`` calls and the NMS fixpoint's host reads
   (``nms.fixpoint_read`` ranges). For the two CLIs of phases 9-10: ms per
   micro-step (host clock, median after the first) beside the train-path
   phase's batch-1 step, ms waiting on the loader, one profiled micro-step
   (busy share, syncs, host reads of a scalar, launches), peak memory at
   batch 2, checkpoint save and restore seconds, eval seconds per val
   image; the dump's ms/img and one profiled image.

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


# the eval path: VOC-size synthetic images (h, w), one landscape, one portrait
EVAL_SIZES = ((375, 500), (500, 375))
AUG_FLASH_PER_IMAGE = 6 * 2 * 3 * 12  # 6 scales x flip x 3 stages x 12 blocks
SINGLE_FLASH_PER_IMAGE = 12  # one backbone pass without the capture


def voc_eval_tree(root: str) -> None:
    """A VOC2012-layout tree: ``EVAL_SIZES`` JPEG images with 2-3 blob
    instances each, ``SegmentationObject`` and ``SegmentationClass``
    palette PNGs (instance boundaries 255), ``ImageSets/Segmentation/val.txt``."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(0)
    for sub in ("JPEGImages", "SegmentationObject", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    palette = [v for i in range(256) for v in (i, (i * 37) % 256, (i * 91) % 256)]
    ids = []
    for i, (h, w) in enumerate(EVAL_SIZES):
        yy, xx = np.mgrid[:h, :w]
        img = rs.rand(h, w, 3) * 60 + 40
        obj = np.zeros((h, w), np.uint8)
        cls = np.zeros((h, w), np.uint8)
        n = 2 + i % 2
        for j in range(n):
            d = (((xx - w * (j + 0.5) / n) / (w / (2.5 * n))) ** 2
                 + ((yy - h * rs.uniform(0.35, 0.65)) / (h * rs.uniform(0.15, 0.3))) ** 2)
            m = d < 1.0
            img[m] += 120.0 * np.eye(3)[j % 3]
            obj[m], cls[m] = j + 1, 1 + (3 * i + 7 * j) % 20
            ring = (d >= 1.0) & (d < 1.1)
            obj[ring & (obj == 0)], cls[ring & (cls == 0)] = 255, 255
        name = f"2012_{i:06d}"
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
            os.path.join(root, "JPEGImages", name + ".jpg"))
        for sub, a in (("SegmentationObject", obj), ("SegmentationClass", cls)):
            png = Image.fromarray(a, mode="P")
            png.putpalette(palette)
            png.save(os.path.join(root, sub, name + ".png"))
        ids.append(name)
    with open(os.path.join(root, "ImageSets", "Segmentation", "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def run_cli(argv, seen_t: set):
    """``attentionshift_torch.tools.test.main(argv)`` in this process with
    the launch counts set to 0 just before: (metric dict, launches, its
    stdout lines). Every token count the backbone's attention met goes
    into ``seen_t``."""
    import contextlib
    import io
    from unittest import mock

    from attentionshift_torch.models import layers
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.tools import test as cli

    real = layers.attention_no_capture

    def spy(q, k, v, pad_interval=None):
        seen_t.add((int(q.shape[2]), pad_interval))
        return real(q, k, v, pad_interval)

    buf = io.StringIO()
    with mock.patch.object(layers, "attention_no_capture", spy), contextlib.redirect_stdout(buf):
        reset_launches()
        res = cli.main(argv)
        sync()
    launches = {name: k.launches for name, k in KERNELS.items()}
    lines = buf.getvalue().strip().splitlines()
    if json.loads(lines[-1]) != res:
        raise AssertionError(f"the CLI's last stdout line {lines[-1]!r} is not its result {res}")
    return res, launches, lines


def phase_eval_path():
    """The evaluation entry point (``tools.test``'s twin) at the full ViT-S
    width of ``configs/attnshift_voc12aug.py`` on a synthetic VOC tree of
    two VOC-size images, from a ``save_params`` export of the seeded model:
    single-scale and aug-test (6 scales x flip), as configured and once more
    each with a lowered score floor. Metric keys, finite values, launches
    (12 / 432 ``flash_fwd`` per image, nothing else), detections at the
    lowered floor; returns what the timing phase needs."""
    import atexit
    import math
    import pickle
    import shutil
    import tempfile

    from attentionshift_torch import native
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.train import save_params

    if not native.native_available():
        raise AssertionError("the port's maskapi library did not build or load on this machine")
    log("[eval] native maskapi: built and loaded (native_available() is True)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    atexit.register(shutil.rmtree, tmp, True)
    root = os.path.join(tmp, "VOC2012")
    voc_eval_tree(root)
    cfg = os.path.join(HERE, "configs", "attnshift_voc12aug.py")
    ckpt = save_params(os.path.join(tmp, "epoch_0"),
                       AttnShiftDetector.from_config(cfg, device="cpu").init_weights(seed=0)
                       .state_dict())
    base = [cfg, ckpt, "--cfg-options", f"data.val.split_file={root}/ImageSets/Segmentation/val.txt",
            f"data.val.voc_root={root}"]
    n = len(EVAL_SIZES)
    keys = ["mAP@0.25", "mAP@0.5", "mAP@0.75"]
    seen_t: set = set()
    launches = {}
    for mode, extra, per_image in (("single", [], 12), ("aug", ["--aug-test"], AUG_FLASH_PER_IMAGE)):
        for thr in (None, INFER_SCORE_THR):
            dump = os.path.join(tmp, f"{mode}-{thr}.pkl")
            opts = [] if thr is None else [f"model.test_score_thr={thr}"]
            res, got, lines = run_cli(base + opts + extra + ["--dump-preds", dump], seen_t)
            floor = "the config's 0.05" if thr is None else thr
            log(f"[eval] {mode}, score floor {floor}: {res}; CLI lines {lines[:1] + lines[-1:]}")
            if sorted(res) != keys or not all(math.isfinite(v) for v in res.values()):
                raise AssertionError(f"eval metrics {res}")
            want = expected_launches(attention_plain=per_image * n)
            if got != want:
                raise AssertionError(f"eval {mode} launches {got} != {want}")
            with open(dump, "rb") as f:
                preds = pickle.load(f)["preds"]
            dets = [len(x) for x in preds["labels"]]
            pixels = [int(m.sum()) for m in preds["masks"]]
            # mask pixels are reported, not asserted: the seeded random mask head's
            # probabilities sit around 0.4-0.6, and the mean over 12 augmentations
            # may stay under the 0.5 threshold everywhere
            log(f"[eval] {mode}, floor {floor}: detections per image {dets}, pasted mask "
                f"pixels over 0.5 {pixels} (reported, not asserted)")
            if [tuple(m.shape[1:]) for m in preds["masks"]] != list(EVAL_SIZES):
                raise AssertionError(f"eval {mode}: masks not pasted at the original sizes")
            if thr is not None and min(dets) == 0:
                raise AssertionError(f"eval {mode} at floor {thr}: an image kept no detection")
            if thr is None:
                launches[mode] = got
    log(f"[eval] launches per image: single {launches['single']['attention_plain'] // n} "
        f"flash_fwd, aug-test {launches['aug']['attention_plain'] // n} flash_fwd, 0 attn_mean, "
        f"no other kernel")
    ts = sorted(t for t, gap in seen_t)
    if any(gap is not None for _, gap in seen_t):
        raise AssertionError(f"the eval path met a pad gap: {sorted(seen_t)}")
    log(f"[eval] token counts T the backbone met (no gap): {ts}")
    return dict(base=base, ts=ts, launches=launches)


def phase_eval_kernel(results: dict, ts) -> None:
    """``flash_fwd`` against its plain version at each T the eval path met,
    (1, 6, T, 64) bf16 without a gap, with a control; then timed in turns
    with SDPA's forward at each T (medians of 6) beside its bound."""
    import torch
    import torch.nn.functional as F

    from attentionshift_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for t in ts:
        q, k, v = (torch.randn((1, HEADS, t, HEAD_DIM), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        ref = attention.attention_reference(q, k, v, None)[0]
        out = attention.attention_no_capture(q, k, v)
        sync()
        tol = bf16_ulps(ref, 4)
        expect(f"attention_plain.eval_T{t}.out", max_err(out, ref), tol,
               "4 bf16 ulps of the largest |out|, no gap, ragged last tile")
        # control: a plain version that drops the last 64 keys must fail the limit
        ctl = max_err(out, attention.attention_reference(q, k, v, (t - 64, t))[0])
        log(f"[check] attention_plain.eval_T{t} control (plain version without the last 64 keys): "
            f"max_abs_err {ctl:.3e} must exceed {tol:.1e}: {'ok' if ctl > tol else 'FAIL'}")
        if not ctl > tol:
            raise AssertionError(f"flash_fwd check at T = {t} cannot see a lost ragged tile")
        (ms, sdpa), (reads, sdpa_reads) = in_turns(
            lambda: attention.attention_no_capture(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v))
        flops = 4.0 * t * t * HEAD_DIM * HEADS
        bound = max(4 * q.numel() * 2 / PEAK_BYTES, flops / PEAK_BF16) * 1e3
        rows.append(dict(t=t, ms=ms, sdpa_ms=sdpa, bound_ms=bound))
        log(f"[time] flash_fwd at T = {t} (eval path, no gap): {ms:.4f} ms = "
            f"{flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s = {ms / sdpa:.2f}x SDPA's forward "
            f"({sdpa:.4f} ms), bound {bound:.4f} ms (operations); readings in turns: kernel "
            f"{[round(x, 4) for x in reads]}, SDPA {[round(x, 4) for x in sdpa_reads]}")
        del q, k, v, ref, out
    results["attention_plain"]["eval_path_T"] = rows


def phase_eval_times(ev: dict) -> None:
    """ms/img of single-scale and aug-test evaluation as configured (host
    clock over the images, the CLI's own model, dataset and tester), then
    one profiled image each: device busy share, blocking host reads
    (``cudaStreamSynchronize``) and the NMS fixpoint's host reads."""
    import torch

    from attentionshift_torch.eval.runner import evaluate
    from attentionshift_torch.tools import test as cli

    n = len(EVAL_SIZES)
    for mode, extra in (("single", []), ("aug", ["--aug-test"])):
        cfg, model, dataset, aug = cli.build(cli.parse_args(ev["base"] + extra))

        def run(limit=None, model=model, dataset=dataset, aug=aug, cfg=cfg):
            evaluate(model, dataset, test_scale=tuple(cfg.data.test_scale), limit=limit,
                     aug_tester=aug, num_classes=int(cfg.model.num_classes), verbose=False)

        run(1)
        sync()
        t0 = time.perf_counter()
        run()
        sync()
        ms_img = (time.perf_counter() - t0) / n * 1e3
        what = "aug-test (6 scales x flip)" if aug else "single-scale (600, 1000)"
        log(f"[time] evaluate, {what}, 2 VOC-size images (500x375, 375x500), bf16, ViT-S, score "
            f"floor {model.test_score_thr} (the config's): {ms_img:.2f} ms/img (host clock over "
            f"the images, dataset reads, pasting and the metric included)")
        avgs, busy = profile_slice(lambda: run(1), ms_img, what=f"{mode} eval image")
        host = torch.autograd.DeviceType.CPU
        count = lambda key: sum(e.count for e in avgs if e.key == key and e.device_type == host)  # noqa: E731
        log(f"[eval] one profiled {mode} image: {count('cudaStreamSynchronize')} "
            f"cudaStreamSynchronize, {count('nms.fixpoint_read')} NMS fixpoint host reads, "
            f"{count('cudaLaunchKernel') + count('cuLaunchKernelEx')} kernel launches, busy "
            f"{'not measured' if busy is None else f'{busy:.1%}'}")
        eval_breakdown(model, dataset, aug, cfg)


def eval_breakdown(model, dataset, aug, cfg) -> None:
    """Host-clock parts of one image's evaluation: reading the image,
    inference (single-scale: the test pipeline and ``make_eval_step``;
    aug-test: the whole ``AugTester`` call), pasting the masks into the
    original frame (``finalize_detections``) and the image's ground truth."""
    import numpy as np
    import torch

    from attentionshift_torch.data.pipeline import TestPipeline
    from attentionshift_torch.eval import finalize_detections
    from attentionshift_torch.train import make_eval_step

    parts = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    raw = timed("read", lambda: dataset[0])
    if aug is None:
        sample = TestPipeline(scale=tuple(cfg.data.test_scale))(raw)
        dev = model.device
        out = timed("inference", lambda: make_eval_step(model)(
            torch.from_numpy(sample["img"])[None].to(dev),
            torch.from_numpy(sample["img_wh"])[None].to(dev)))
        args = [t[0].cpu().numpy() for t in out.dets] + [out.mask_probs[0].cpu().numpy(),
                                                          sample["scale_wh"], sample["orig_wh"]]
    else:
        a = timed("inference", lambda: aug(raw["img"]))
        args = [a[k] for k in ("boxes", "scores", "labels", "valid", "mask_probs")] + [
            np.asarray([1.0, 1.0]), np.asarray([raw["img"].shape[1], raw["img"].shape[0]])]
    res = timed("paste", lambda: finalize_detections(*args))
    timed("ground truth", lambda: dataset.gt_instances(0))
    log(f"[time] one {'aug-test' if aug else 'single-scale'} image's parts (host clock, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
        + f" ({len(res['labels'])} detections pasted at {raw['img'].shape[1]}x{raw['img'].shape[0]})")


# the train CLI's synthetic point tree: landscape VOC-size JPEGs, so that every
# batch lands in the 800x1344 bucket of the config's 11 train scales
TRAIN_CLI_IMAGES, TRAIN_CLI_SIZE = 8, (375, 500)
TRAIN_CLI_STEPS = 4  # micro-steps per invocation: batch 2, accumulate_steps 2
TRAIN_CLI_VAL = 2  # val images per evaluation
PSEUDO_SCALE = (800, 1333)  # the dump's --scale, its default
# per micro-step at the config's batch of 2: the attention kernels carry the
# batch in one launch; CCL and mean-shift run once per image
TRAIN_CLI_LAUNCHES = dict(TRAIN_LAUNCHES, ccl_batch=2, meanshift_fixpoint=2)
SEED_LAUNCHES = {"attention_capture": CAM_LAYERS, "attention_plain": 12 - CAM_LAYERS,
                 "ccl_batch": 1, "meanshift_fixpoint": 1}


def voc_point_tree(root: str) -> dict:
    """``TRAIN_CLI_IMAGES`` landscape JPEGs with 2-3 blob instances each and a
    ``center_points``-style COCO json (one point per instance) under
    ``root``; returns the train node's paths."""
    import numpy as np
    from PIL import Image

    from attentionshift_torch.data.voc import VOC_CLASSES

    rs = np.random.RandomState(1)
    h, w = TRAIN_CLI_SIZE
    yy, xx = np.mgrid[:h, :w]
    images, annotations = [], []
    for i in range(TRAIN_CLI_IMAGES):
        img = rs.rand(h, w, 3) * 60 + 40
        n = 2 + i % 2
        for j in range(n):
            cx, cy = w * (j + 0.5) / n, h * rs.uniform(0.35, 0.65)
            m = ((xx - cx) / (w / (2.5 * n))) ** 2 + ((yy - cy) / (h * 0.2)) ** 2 < 1.0
            img[m] += 120.0 * np.eye(3)[j % 3]
            annotations.append(dict(id=len(annotations), image_id=i,
                                    category_id=1 + (3 * i + 7 * j) % 20,
                                    point=[float(xx[m].mean()), float(yy[m].mean())]))
        name = f"2012_train_{i:06d}.jpg"
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(
            os.path.join(root, "JPEGImages", name))
        images.append(dict(id=i, file_name=name, width=w, height=h))
    ann = os.path.join(root, "Annotations_coco", "center_points", "gt_center_train2012.json")
    os.makedirs(os.path.dirname(ann), exist_ok=True)
    with open(ann, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=k + 1, name=c) for k, c in enumerate(VOC_CLASSES)]), f)
    return dict(ann_file=ann, img_prefix=os.path.join(root, "JPEGImages"))


def mae_state_dict(depth: int = 12, d: int = EMBED, patch: int = 16) -> dict:
    """A seeded random MAE ViT-S encoder ``state_dict`` under MAE's key
    names, with its final norm (which the graft leaves out)."""
    import torch

    gen = torch.Generator().manual_seed(5)
    r = lambda *shape: torch.randn(shape, generator=gen) * 0.02  # noqa: E731
    sd = {"patch_embed.proj.weight": r(d, 3, patch, patch), "patch_embed.proj.bias": r(d),
          "cls_token": r(1, 1, d), "pos_embed": r(1, 1 + (224 // patch) ** 2, d),
          "norm.weight": 1.0 + r(d), "norm.bias": r(d)}
    for i in range(depth):
        for norm in ("norm1", "norm2"):
            sd[f"blocks.{i}.{norm}.weight"], sd[f"blocks.{i}.{norm}.bias"] = 1.0 + r(d), r(d)
        for name, (o, n) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                             ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            sd[f"blocks.{i}.{name}.weight"], sd[f"blocks.{i}.{name}.bias"] = r(o, n), r(o)
    return sd


def check_graft(model, sd: dict) -> int:
    """Every MAE tensor the graft maps against the backbone's, exactly: the
    patch projection through the port's (p, p, C) input order, the others
    as they are. Returns how many were compared."""
    import torch

    params = model.backbone.state_dict()
    n = 0
    for key, t in sd.items():
        if key.startswith("norm."):
            continue
        want = t.permute(0, 2, 3, 1).reshape(t.shape[0], -1) if key == "patch_embed.proj.weight" else t
        if not torch.equal(params[key].cpu(), want):
            raise AssertionError(f"MAE graft: backbone.{key} differs from the checkpoint's")
        n += 1
    return n


def launch_counts() -> dict:
    from attentionshift_torch.ops._build import KERNELS

    return {name: k.launches for name, k in KERNELS.items()}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def counting(module, name: str, calls: list):
    """Patch ``module.name`` with a pass-through that appends, per call, its
    launch counts (after minus before, read after a synchronize), its
    host-clock ms and its arguments and result to ``calls``."""
    from unittest import mock

    fn = getattr(module, name)

    def run(*args, **kwargs):
        before = launch_counts()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        after = launch_counts()
        calls.append(dict(launches={k: after[k] - before[k] for k in after}, ms=ms, args=args,
                          out=out))
        return out

    return mock.patch.object(module, name, run)


def gradient_tops(store: dict):
    """Patch ``Optimizer.step`` to keep the largest |gradient| per submodule."""
    from unittest import mock

    from attentionshift_torch.train.optim import Optimizer

    inner = Optimizer.step

    def step(self, grads):
        for name, g in zip(self.names, grads):
            if g is not None:
                m = name.split(".", 1)[0]
                store[m] = max(store.get(m, 0.0), float(g.float().abs().max()))
        return inner(self, grads)

    return mock.patch.object(Optimizer, "step", step)


def first_gradients(store: dict):
    """Patch ``Optimizer.step`` and the train step's ``_mean_over_ranks`` to
    keep copies of the first gradients the optimizer receives (``"opt"``)
    and of the first all-reduce's inputs and outputs (``"mean"``)."""
    import contextlib
    import importlib
    from unittest import mock

    import torch

    from attentionshift_torch.train.optim import Optimizer

    step_mod = importlib.import_module("attentionshift_torch.train.step")
    inner, mean = Optimizer.step, step_mod._mean_over_ranks

    def step(self, grads):
        store.setdefault("opt", [  # an unused parameter's None counts as 0, as in the step
            torch.zeros_like(p) if g is None else g.detach().clone()
            for g, p in zip(grads, self.params)])
        return inner(self, grads)

    def mean_over_ranks(tensors, group):
        out = mean(tensors, group)
        store.setdefault("mean", ([t.detach().clone() for t in tensors],
                                  [o.detach().clone() for o in out]))
        return out

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(Optimizer, "step", step))
    stack.enter_context(mock.patch.object(step_mod, "_mean_over_ranks", mean_over_ranks))
    return stack


def phase_train_cli():
    """The training entry point (``tools.train``'s twin) in this process at
    the full ViT-S width of ``configs/attnshift_voc12aug.py`` as it is
    (batch 2, accumulate_steps 2, 11 train scales, remat and drop path on),
    on a synthetic point tree with a synthetic MAE checkpoint. Invocation 1
    runs 4 micro-steps of epoch 0, saves ``epoch_1`` and evaluates 2 val
    images; invocation 2, under a world-size-1 NCCL process group,
    auto-resumes, runs 4 micro-steps of epoch 1, saves ``epoch_2`` and
    evaluates. Checks the graft, the launch counts per micro-step and per
    invocation, the losses, gradients, updates, counters and the group's
    branch; returns what the later phases need."""
    import atexit
    import math
    import shutil
    import socket
    import tempfile
    from unittest import mock

    import torch

    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.parallel import mesh
    from attentionshift_torch.tools import train as cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    atexit.register(shutil.rmtree, tmp, True)
    root = os.path.join(tmp, "VOC2012")
    voc_eval_tree(root)
    node = voc_point_tree(root)
    sd = mae_state_dict()
    mae = os.path.join(tmp, "mae_pretrain_vit_small.pth")
    torch.save({"model": sd}, mae)
    work = os.path.join(tmp, "work")
    cfg = os.path.join(HERE, "configs", "attnshift_voc12aug.py")
    opts = ["--cfg-options", f"data.train.ann_file={node['ann_file']}",
            f"data.train.img_prefix={node['img_prefix']}",
            f"data.val.split_file={root}/ImageSets/Segmentation/val.txt",
            f"data.val.voc_root={root}", f"pretrained={mae}", "schedule.total_epochs=2",
            "runtime.log_interval=1", "schedule.warmup_iters=2"]
    argv = [cfg, "--work-dir", work, "--max-steps", str(TRAIN_CLI_STEPS),
            "--validate-limit", str(TRAIN_CLI_VAL)] + opts

    run = cli.build(cli.parse_args(argv))
    c, bb = run.cfg, run.model.backbone
    if not (int(c.data.batch_size) == 2 and int(c.optimizer.accumulate_steps) == 2
            and len(c.data.train_scales) == 11 and bb.use_remat and bb.drop_path_rate > 0
            and run.model.embed_dim == EMBED and len(bb.blocks) == 12):
        raise AssertionError("the train CLI phase runs the config as it is")
    log(f"[train-cli] MAE graft before the first step: {check_graft(run.model, sd)} tensors equal "
        f"to the checkpoint's through the port's layout")
    init = {k: v.detach().cpu().clone() for k, v in run.model.state_dict().items()}
    del run
    per_step = {k: 0 for k in launch_counts()}
    per_step.update(TRAIN_CLI_LAUNCHES)
    out = {}
    for inv in (1, 2):
        env = {}
        if inv == 2:
            with socket.socket() as s:
                s.bind(("localhost", 0))
                env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                           MASTER_PORT=str(s.getsockname()[1]))
        calls, grads, first = [], {}, {}
        mesh.COUNTS.clear()
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.dict(os.environ, env), counting(cli, "train_step", calls), \
                gradient_tops(grads), first_gradients(first):
            reset_launches()
            stats = cli.main(argv)
            sync()
        total = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        steps = [cl["launches"] for cl in calls]
        if len(steps) != TRAIN_CLI_STEPS or any(d != per_step for d in steps):
            raise AssertionError(f"train CLI {inv}: launches per micro-step {steps} != {per_step}")
        want = {k: TRAIN_CLI_STEPS * v for k, v in per_step.items()}
        want["attention_plain"] += SINGLE_FLASH_PER_IMAGE * TRAIN_CLI_VAL
        if total != want:
            raise AssertionError(f"train CLI {inv}: launches {total} != {want}")
        log(f"[train-cli] {inv}: launches per micro-step {nonzero(steps[0])} (all "
            f"{TRAIN_CLI_STEPS} equal); the invocation's {nonzero(total)} "
            f"({SINGLE_FLASH_PER_IMAGE * TRAIN_CLI_VAL} flash_fwd of them in the evaluation)")
        vals = stats["metrics"]
        if set(vals) != LOSS_KEYS | {"loss_total"} or not all(map(math.isfinite, vals.values())):
            raise AssertionError(f"train CLI {inv}: metrics {vals}")
        with open(os.path.join(work, "train_log.jsonl")) as f:
            records = [json.loads(line) for line in f]
        if len(records) != inv * TRAIN_CLI_STEPS or set(records[-1]) < set(vals):
            raise AssertionError(f"train_log.jsonl: {len(records)} records")
        val = stats["val"]
        if len(val) != 1 or sorted(val[0]) != ["mAP@0.25", "mAP@0.5", "mAP@0.75"] or not all(
                map(math.isfinite, val[0].values())):
            raise AssertionError(f"train CLI {inv}: val metrics {val}")
        dead = [m for m in SUBMODULES if not grads.get(m, 0.0) > 0]
        if dead:
            raise AssertionError(f"train CLI {inv}: no gradient reached {dead}")
        ckpt = torch.load(os.path.join(work, f"epoch_{inv}"), map_location="cpu", weights_only=True)
        if (ckpt["epoch"], ckpt["step"], ckpt["opt_state"]["count"]) != (
                inv, inv * TRAIN_CLI_STEPS, inv * TRAIN_CLI_STEPS // 2):
            raise AssertionError(f"epoch_{inv}: epoch {ckpt['epoch']}, step {ckpt['step']}, "
                                 f"opt.count {ckpt['opt_state']['count']}")
        moved = {m: 0 for m in SUBMODULES}
        for k, v in ckpt["params"].items():
            if not bool(torch.isfinite(v.float()).all()):
                raise AssertionError(f"epoch_{inv}: {k} is not finite")
            moved[k.split(".", 1)[0]] += int(not torch.equal(v, init[k]))
        if not all(moved.values()):
            raise AssertionError(f"epoch_{inv}: parameters unchanged since the init in {moved}")
        out[inv] = dict(stats=stats, calls=calls, total=total, peak=peak, counts=dict(mesh.COUNTS),
                        first=first)
        log(f"[train-cli] {inv}: last metrics {({k: round(v, 4) for k, v in sorted(vals.items())})}"
            f"; val {val[0]}; tensors changed since the init per submodule {moved}; opt.count "
            f"{ckpt['opt_state']['count']} after {inv * TRAIN_CLI_STEPS} micro-steps; all-reduces "
            f"{dict(mesh.COUNTS)}")
    s2 = out[2]["stats"]
    if s2["resumed"] != os.path.join(work, "epoch_1") or s2["start_epoch"] != 1:
        raise AssertionError(f"invocation 2 did not resume from epoch_1: {s2['resumed']}")
    log(f"[train-cli] 2: resumed from epoch_1 at epoch {s2['start_epoch']}")
    if out[1]["counts"]:
        raise AssertionError(f"invocation 1 ran collectives: {out[1]['counts']}")
    c2 = out[2]["counts"]
    if c2.get("gradients") != TRAIN_CLI_STEPS or not c2.get("normalisers"):
        raise AssertionError(f"invocation 2 did not take the process-group branch: {c2}")
    return dict(argv=argv, opts=opts, cfg=cfg, work=work, tmp=tmp, out=out)


def phase_train_cli_same_step(tc: dict):
    """Invocation 2's first step (world-size-1 NCCL group) once more without
    a group, from ``epoch_1`` on the batch it was given. A mean over one
    rank is the identity, so the two steps are equal bitwise: every loss,
    and every gradient the optimizer receives; and the group's gradient
    all-reduce (one flat f32 buffer, split back into each gradient's shape)
    returns its inputs bitwise. Returns the run (resumed from ``epoch_1``,
    one step on) and that batch, for the timing phase."""
    import torch

    from attentionshift_torch.tools import train as cli

    first = tc["out"][2]["calls"][0]
    _, batch, epoch = first["args"]
    grouped = {k: v.clone() for k, v in first["out"].items()}
    g_first = tc["out"][2]["first"]
    for inv in (1, 2):  # let the invocations' runs go
        tc["out"][inv].pop("first")
        for cl in tc["out"][inv]["calls"]:
            cl.pop("args"), cl.pop("out")
    argv = tc["argv"] + ["--resume-from", os.path.join(tc["work"], "epoch_1"), "--no-auto-resume"]
    run = cli.build(cli.parse_args(argv))
    if run.group is not None:
        raise AssertionError("the comparison run has a process group")
    alone = {}
    with first_gradients(alone):
        again = cli.train_step(run, batch, epoch)
    if "mean" in alone or "mean" not in g_first:
        raise AssertionError("the gradient all-reduce ran in the wrong run")
    ins, outs = g_first["mean"]
    if len(ins) != len(outs) or not all(
            o.shape == i.shape and o.dtype == torch.float32 and torch.equal(o, i.float())
            for i, o in zip(ins, outs)):
        raise AssertionError("the world-size-1 gradient all-reduce changed a gradient")
    if set(grouped) != set(again) or not all(
            torch.equal(v.float(), again[k].float()) for k, v in grouped.items()):
        raise AssertionError(f"group {grouped} != no group {again}")
    g, a = g_first["opt"], alone["opt"]
    if len(g) != len(a) or not all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(g, a)):
        worst = max(float((x.float() - y.float()).abs().max()) for x, y in zip(g, a))
        raise AssertionError(f"the gradients the optimizer received differ: max |diff| {worst:.3e}")
    log(f"[train-cli] invocation 2's first step (group of 1) against the same step without a "
        f"group: all {len(grouped)} losses and all {len(g)} gradients the optimizer received equal "
        f"bitwise; the group's gradient all-reduce returned its {len(ins)} inputs bitwise")
    return run, batch, epoch


def phase_pseudo_cli(tc: dict) -> dict:
    """The pseudo-label dump (``tools.gen_pseudo_labels``'s twin) on
    ``epoch_2`` over the 8 train images at scale (800, 1333): launches per
    image (#1-#4 only), every RLE decoded to its image's size with its
    area, every box inside its image, category ids in 1..20."""
    from attentionshift_torch import native
    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.tools import gen_pseudo_labels as gpl

    path = os.path.join(tc["tmp"], "pseudo_train.json")
    argv = [tc["cfg"], os.path.join(tc["work"], "epoch_2"), "--out", path, "--scale",
            *map(str, PSEUDO_SCALE)] + tc["opts"]
    calls = []
    with counting(gpl, "pseudo_label_image", calls):
        reset_launches()
        coco = gpl.main(argv)
        sync()
    total = launch_counts()
    want = {k: SEED_LAUNCHES.get(k, 0) for k in total}
    per_image = [cl["launches"] for cl in calls]
    for cl in calls:  # let the dump's model go
        cl.pop("args"), cl.pop("out")
    if len(per_image) != TRAIN_CLI_IMAGES or any(d != want for d in per_image):
        raise AssertionError(f"pseudo dump: launches per image {per_image} != {want}")
    if total != {k: TRAIN_CLI_IMAGES * v for k, v in want.items()}:
        raise AssertionError(f"pseudo dump: launches {total}")
    with open(path) as f:
        if json.load(f) != coco:
            raise AssertionError("the json written is not the dump's result")
    sizes = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}
    if len(sizes) != TRAIN_CLI_IMAGES or not coco["annotations"]:
        raise AssertionError(f"pseudo dump: {len(sizes)} images, {len(coco['annotations'])} anns")
    for k, ann in enumerate(coco["annotations"], 1):
        h, w = sizes[ann["image_id"]]
        seg = ann["segmentation"]
        m = native.rle_decode(native.rle_from_string(seg["counts"], seg["size"]))
        x, y, bw, bh = ann["bbox"]
        if not (ann["id"] == k and m.shape == (h, w) and float(m.sum()) == ann["area"]
                and 0 <= x and 0 <= y and bw > 0 and bh > 0 and x + bw <= w and y + bh <= h
                and 1 <= ann["category_id"] <= 20):
            raise AssertionError(f"pseudo dump: annotation {ann['id']} malformed: {ann['bbox']}, "
                                 f"mask {m.shape} vs {(h, w)}, area {ann['area']}")
    per = [sum(a["image_id"] == i for a in coco["annotations"]) for i in sorted(sizes)]
    log(f"[pseudo-cli] {len(coco['annotations'])} annotations over {len(sizes)} images "
        f"{per}, every RLE decoded at its image's size with its area, boxes inside, "
        f"category ids in 1..20; launches per image {nonzero(per_image[0])} (all "
        f"{TRAIN_CLI_IMAGES} equal)")
    return dict(calls=calls, total=total, argv=argv)


def phase_cli_times(tc: dict, same: tuple, pc: dict, ms_step_b1: float) -> None:
    """Times of the two entry points (host clock unless said): ms per
    micro-step through the train CLI (median of the steps after the first)
    beside the train-path phase's ms/step at batch 1, ms waiting on the
    loader, one profiled CLI step (busy share, host reads, syncs), peak
    memory at batch 2, checkpoint save and restore seconds, eval seconds
    per val image; the dump's ms/img and one profiled image."""
    import statistics

    import torch

    from attentionshift_torch.tools import gen_pseudo_labels as gpl
    from attentionshift_torch.tools import train as cli
    from attentionshift_torch.train import restore_checkpoint, save_checkpoint

    host = torch.autograd.DeviceType.CPU

    def counts(avgs, *keys):
        return sum(e.count for e in avgs if e.key in keys and e.device_type == host)

    for inv in (1, 2):
        o = tc["out"][inv]
        st = o["stats"]
        ms = statistics.median(st["step_ms"][1:])
        log(f"[time] train CLI {inv}{' (NCCL group of 1)' if inv == 2 else ''}: "
            f"{ms:.2f} ms per micro-step at batch 2 (median of steps 2-{len(st['step_ms'])}, host "
            f"clock, losses read back each step; first {st['step_ms'][0]:.2f}), the train-path "
            f"phase's batch-1 step {ms_step_b1:.2f} ms; waiting on the loader "
            f"{[round(x, 2) for x in st['wait_ms']]} ms; peak {o['peak']:.0f} MiB allocated; "
            f"checkpoint save {st['save_s'][0]:.3f} s; eval {st['eval_s'][0] / TRAIN_CLI_VAL:.3f} "
            f"s per val image")
    run, batch, epoch = same
    avgs, busy = profile_slice(lambda: cli.train_step(run, batch, epoch),
                               statistics.median(tc["out"][1]["stats"]["step_ms"][1:]),
                               what="train CLI micro-step (batch 2)")
    log(f"[train-cli] one profiled micro-step: {counts(avgs, 'cudaStreamSynchronize')} "
        f"cudaStreamSynchronize, {counts(avgs, 'aten::_local_scalar_dense')} host reads of a "
        f"scalar, {counts(avgs, 'cudaLaunchKernel', 'cuLaunchKernelEx')} kernel launches, busy "
        f"{'not measured' if busy is None else f'{busy:.1%}'}")
    t0 = time.perf_counter()
    path = save_checkpoint(os.path.join(tc["tmp"], "timing"), run.state)
    t1 = time.perf_counter()
    restore_checkpoint(path, run.state)
    sync()
    t2 = time.perf_counter()
    log(f"[time] checkpoint of the full train state ({os.path.getsize(path) / 2**20:.0f} MiB): "
        f"save {t1 - t0:.3f} s, restore {t2 - t1:.3f} s")
    del run
    ms = [cl["ms"] for cl in pc["calls"]]
    log(f"[time] gen_pseudo_labels at scale {PSEUDO_SCALE}: {statistics.median(ms[1:]):.2f} ms/img "
        f"(median of images 2-{len(ms)}, host clock; first {ms[0]:.2f})")
    cfg, model, dataset = gpl.build(gpl.parse_args(pc["argv"]))
    sample = dataset[0]
    gpl.pseudo_label_image(model, sample, 0, PSEUDO_SCALE, int(cfg.data.max_gt))
    avgs, busy = profile_slice(
        lambda: gpl.pseudo_label_image(model, sample, 0, PSEUDO_SCALE, int(cfg.data.max_gt)),
        statistics.median(ms[1:]), what="pseudo-label dump image")
    log(f"[pseudo-cli] one profiled image: {counts(avgs, 'cudaStreamSynchronize')} "
        f"cudaStreamSynchronize, busy {'not measured' if busy is None else f'{busy:.1%}'}")


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


# torch.profiler ranges the port opens (record_function): host reads of the NMS fixpoint
PROFILER_RANGES = ("nms.fixpoint_read",)


def profile_slice(run, ms_img: float, top: int = 12, what: str = "call"):
    """Where one call's time goes: device time by kernel (torch.profiler;
    the ``top`` kernels and every hand-written one) and the device's busy
    share of the call's wall time. Returns the profile's ``key_averages()``
    and the busy share (None when the profiler saw no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events, without the device-side copies of the program's own
    # profiler ranges (their time is their kernels')
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in PROFILER_RANGES]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if dev_ms <= 0:
        log("[profile] device time: not measured (the profiler recorded no device events)")
        return prof.key_averages(), None
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
    return prof.key_averages(), dev_ms / wall_ms


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
    ev = phase_eval_path()
    tc = phase_train_cli()
    same = phase_train_cli_same_step(tc)
    pc = phase_pseudo_cli(tc)
    phase_times(results, inp, model, slice_inp, gen)
    phase_main_path_inputs(results, handed)
    ms_step = phase_train_times(state, step_fn, batch, train_gen)
    phase_cli_times(tc, same, pc, ms_step)
    del same
    phase_infer_times(model, eval_step, infer_img, infer_wh)
    phase_eval_kernel(results, ev["ts"])
    phase_eval_times(ev)
    eval_single, eval_aug = ev["launches"]["single"], ev["launches"]["aug"]
    train_cli = {k: tc["out"][1]["total"][k] + tc["out"][2]["total"][k] for k in KERNELS}
    pseudo_cli = pc["total"]
    table = []
    for name, kern in KERNELS.items():
        r = results[name]
        # launches: each path was driven with the counts at 0 and read right after
        table.append(dict(name=name, route="cuda", source=f"attentionshift_torch/csrc/{kern.source}.cu",
                          replaces=kern.replaces,
                          launches=(seed_launches[name] + infer_launches[name]
                                    + train_launches[name] + tool_launches[name]
                                    + eval_single[name] + eval_aug[name] + train_cli[name]
                                    + pseudo_cli[name]),
                          launches_seed_pseudo_gt=seed_launches[name],
                          launches_simple_test=infer_launches[name],
                          launches_train_steps=train_launches[name],
                          launches_microbench_tool=tool_launches[name],
                          launches_eval_single=eval_single[name],
                          launches_eval_aug_test=eval_aug[name],
                          launches_train_cli=train_cli[name],
                          launches_gen_pseudo_labels=pseudo_cli[name],
                          max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                          bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"],
                          **{key: r[key] for key in ("mean_pass_ms", "ms_main_path_input",
                                                     "eval_path_T") if key in r}))
    log(smi)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
