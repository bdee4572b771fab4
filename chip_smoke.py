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
   (1, 6, 4301, 64): an odd T with a ragged last tile; each mean entry
   within ``attention_variants.mean_limit``; every variant also bitwise
   equal in two calls; v5's cluster size printed; the capture pair's mean
   entry by entry within one bf16 step, ``attention.capture_mean_limit``,
   with controls that must fail it: the temperature 10 % off and the last
   head off); the four attention kernels at head dim 32 and above the mean
   pass's resident heads, forward and backward pair, each check with a
   control: (1, 24, 1276, 32), (1, 6, 4352, 32) with the bench gap,
   (1, 24, 1276, 64), (2, 17, 300, 64), (1, 24, 190, 32) over seeds 0-15;
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
11. the refinement stage (AttnShift-dagger): first the TINY Mask R-CNN
   train step (f32, ResNet depths (1, 1, 1, 1), batch 2 at 128x128) on the
   card against the same step on the CPU from the same init and draws
   (losses 2e-4, gradients 2e-3 of each tensor's largest entry); then the
   twin of ``tools/train.py`` on ``configs/mrcnn_refine_voc.py`` as it is
   (ResNet-50-FPN, f32, batch 2 at (800, 1333), 1000 proposals, 512 RCNN
   samples, 128 mask RoIs, SGD 0.0025) over the json that phase 10 wrote,
   with a synthetic torchvision ResNet-50 checkpoint as ``pretrained``:
   the graft checked tensor by tensor, invocation 1 runs 4 micro-steps and
   saves ``epoch_1``, invocation 2 auto-resumes for 4 more; finite losses,
   a gradient for and a move of every trainable tensor, the frozen stem,
   ``layer1`` and every FrozenBN buffer bitwise unchanged, ``opt.count``;
   the twin of ``tools/test.py`` on ``epoch_2``, single-scale and
   ``--aug-test``, over the 2 val images: the metric keys, finite. No
   hand-written kernel launches anywhere on this path (asserted; the kernel
   table's ``launches_refine_train`` / ``launches_refine_eval``). Its times
   beside the card's name and power limit: ms per micro-step (host clock,
   median of steps 2-4), peak memory, one profiled micro-step (device busy
   time and its top ops), single-scale and aug-test ms/img;
12. the train variants through the twin of ``tools/train.py``, each config
   as it is: ``configs/attnshift_coco.py`` (ViT-S, 80 classes, batch 2,
   ``max_gt`` 40, all 12 blocks captured, the RepPoints head, 11 scales
   480-800 x 1333, brightness jitter) on a synthetic COCO tree of 8
   images with 6-40 instances: 4 micro-steps, ``epoch_1``, 2 val images
   through ``COCOEvalDataset``; exactly 12/12/12/12/2/2 launches per
   micro-step, finite ``loss_rp_*``, a gradient in and a move of every
   submodule and of ``reppoints_head_0``, G = 40 filled, and CCL (480
   planes), mean-shift (G = 40) and the capture pair held against their
   plain versions on the inputs this path handed them;
   ``configs/attnshift_voc12aug_ts.py`` and
   ``configs/attnshift_voc12aug_keypoint.py`` on phase 9's VOC tree, 2
   micro-steps each: the teacher's forward exactly 7 capture + 5 plain
   launches per micro-step and no backward, one teacher tensor after each
   step against m * teacher + (1 - m) * student recomputed on the host,
   ``loss_keypoint_align`` finite; the bench-geometry train step with two
   RepPoints heads, ``with_deform_sup`` and the MAE head (finite losses,
   the suffixed keys, gradients in both heads and the decoder);
   ``configs/attnshift_coco_vitb.py`` (768 wide, 12 heads, a synthetic MAE
   ViT-B checkpoint), one micro-step, its kernels checked on its own
   inputs (D = 768, 12 heads). Each with its ms per micro-step and peak
   memory beside the card's name and power limit, the COCO one with a
   profiled micro-step;
13. Swin (``configs/attnshift_voc12aug_swin.py``'s ``swin`` dict: embed 96,
   depths 2/2/6/2, heads 3/6/12/24, window 7, 100 point tokens, 4 global
   blocks, 20 classes; seeded random weights, bf16, batch 1) at 896x1344,
   the smallest size at or above the bench's whose every stage map the
   window 7 divides: one forward (exactly 4 ``flash_fwd`` + ``attn_mean``
   launches at (1, 24, 1276, 32)), the rollout and ``candidate_boxes`` at
   cam stride 8 (one CCL launch on (112, 168) planes), one backward of a
   scalar of ``outputs_class``, ``outputs_coord`` and ``last_feat``
   (exactly 4 + 4 backward launches at head dim 32); shapes, finite
   values, boxes, gradients; the kernels on the path's own q, k, v and
   upstream gradient; the whole forward against the same module with
   plain attention on the card; host ms, profiled device busy, peak
   memory. Then the memory bank and Sinkhorn on the card against the CPU;
14. the remaining model modules, each at its full width: ``point2bbox``
   (the point-token decoding) on phase 4's detector for two 800x1344
   images one at a time (exactly 7 / 5 / 1 capture / plain / CCL launches
   per image; the CCL input's 100 planes of 100x168 copied to the CPU:
   the plain CCL's sweeps, the planes at the sweep cap counted, labels
   equal to the kernel's, boxes within 1e-4 px; a flipped pixel as the
   control); the mean-field CRF (G = 20 on 4200 patches, D = 384) and the
   water fill on that path's CAMs and features, card against CPU; the
   supervision-point generator at the COCO config's shapes ((160, 200,
   336) hulls) and the deformable attention (256 channels, 4 heads, batch
   2 at stride 16), card against CPU, forward and backward; the MAE
   encoder as ViT-B at 896x1344 (split window-14 / global attention,
   LayerScale, the pyramid; exactly 12 ``flash_fwd`` forward and 12 + 12
   backward launches, its kernels on a windowed and a global block's own
   q, k, v) and the MIM ViT-S at 224 with a 40 % mask feeding the iBOT
   (8192 / 8192) and DINO (65536) heads (12 / 12 + 12 launches), each
   against the same module with plain attention; grad-CAM on phase 4's
   detector (its own top detection) with the f32 heads card against CPU,
   EigenCAM and FeatmapAM; ``tools.browse_dataset`` and
   ``tools.analysis.analyze_results`` once each (the pngs exist, none
   blank). Each check with a control that must fail it; host ms, busy
   share and peak memory beside the card's name and power limit;
15. the learning tools at 512x512 (the ViT-S flagship, bf16, ``max_gt``
   8): ``tools.debug_overfit`` whole (60 steps on 8 discs, its own loss
   checks) and ``tools.analysis.learning_check`` with every branch (20
   steps on 16 two-lobed images, milestones 0 and 20 scored on 8 held-out
   images with the detection chain, a 10-step dagger loop): milestone rows
   well-formed and finite; exact launches per train step, scored image and
   tested image; CCL, mean-shift and both attention pairs on the inputs
   the learning check handed them (T = 1125, no gap; 56 planes of 32x32);
   ms per train step (host clock, median), one profiled step, peak memory;
   then the serving export (``tools/deployment/export_program.py``): the
   VOC config's ``simple_test`` at 800x1344 (ViT-S, bf16, weights baked)
   exported with ``torch.export``, saved, reloaded and held to the live
   model at 1e-5; its graph holds 12 plain-attention custom ops and the
   NMS ``while_loop``; one run of the reloaded program launches exactly 12
   ``flash_fwd``; exported and eager ms/img in turns; the refinement
   config's Mask R-CNN exported and round-tripped once; and the last user
   tools: the FPS harness at 608x1024, ``get_flops`` at 512x512 (its
   attention count against 12 x 4 B H T^2 d) and the robustness benchmark
   on the eval tree (contrast, severity 1); then tensor, sequence and
   pipeline parallelism (``phase_parallel``): the script run again as two
   ranks that share the card over gloo (``--parallel-rank``), the VOC
   flagship at 800x1344 (T = 4352): the TP forward (3 of 6 heads per rank;
   each capture layer's all-reduced head mean against the single-rank
   kernel on the gathered q, k, v, per entry), the SP forward (2176 tokens
   per rank), the PP forward (2 stages x 2 microbatches) and one dp1 x tp2
   x sp train step, each against the single-rank path with the f32 plain
   path as the witness of bf16 rounding, with controls (the capture mean,
   the row-parallel sums and the SP LayerNorm gradient not reduced); per
   path and rank: host ms, launches of #1, #2, #5, #6 (asserted) and the
   gloo staging time; then the diagnosis and profiling twins
   (``phase_diagnosis``) at their JAX defaults, full width: the four
   profiling tools (``--steps 3``; exact launches of #1-#4 per call; each
   kernel on the tool's own inputs against its plain version, the
   backbone's q, k, v at T = 4301 through both attention pairs forward and
   backward; the stage times), ``calibrate_overhead``, ``trace_ops`` on a
   profiled ``seed_pseudo_gt`` call (rows for ``flash_fwd``, ``attn_mean``,
   CCL and mean-shift), ``warm_cache`` (every kernel library cached),
   ``diagnose_det`` (20 steps, 2 + 2 images), ``probe_rpn`` with
   ``--save-ckpt`` then ``--ckpt`` (equal reports) and ``fidelity_study``
   (10 steps, 2 images, ``--out`` in a temporary directory; CCL on the
   exact config's (56, 512, 512) planes against its plain version, the
   planes each configuration's sweep cap cut), each with its launches
   asserted (the kernel table's ``launches_diagnosis``);
16. times with CUDA events: every kernel, its plain version, the library
   call where one exists, ms/img of the pseudo-label path and of
   inference and ms per train step, each with one profiled call. The
   attention kernels and their SDPA yardsticks (the forward with the same
   mask; the backward of it beside the backward pair) are read in turns,
   kernel, library, library, kernel, ..., and each reports the median of
   its readings; the flash pass's and the backward pair's TFLOP/s and
   ratio to SDPA, the mean pass's own time, and an exp floor (B*H*T^2
   exp2 per pass at 16 per clock per SM, at the SM clock nvidia-smi reads
   while the flash pass runs) beside the forward bounds. At the
   microbenchmark's shape (1, 6, 4301, 64) v2, v3, v4, v5, v6, the shipped
   capture pair and SDPA's forward are read in turns, each with its ratio to the
   bound and to the two-pass exp floor and its kernels' registers (ptxas,
   as the build reported them). For the eval
   path: ``flash_fwd`` against its plain version at every T it met,
   (1, 6, T, 64) bf16 without a gap (4 bf16 ulps, with a control that
   drops the last 64 keys), timed in turns with SDPA's forward at each T
   beside its bound; ms/img of single-scale and aug-test evaluation (host
   clock over the images), and one profiled image of each: device busy
   share, ``cudaStreamSynchronize`` calls, host reads of a scalar and those
   of them inside the NMS ``while_loop`` (``nms.while_loop`` ranges). For
   the two CLIs of phases 9-10: ms per
   micro-step (host clock, median after the first) beside the train-path
   phase's batch-1 step, ms waiting on the loader, one profiled micro-step
   (busy share, syncs, host reads of a scalar, launches), peak memory at
   batch 2, checkpoint save and restore seconds, eval seconds per val
   image; the dump's ms/img and one profiled image. The d = 32 kernels
   at Swin's (1, 24, 1276, 32) on that path's inputs, read in turns with
   SDPA's forward and backward, with their exp floors; the d = 64 mean
   pass streamed at 24 heads beside the resident one at 12.

A failing phase raises and the script exits non-zero. The line before
the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.

    python3 chip_smoke.py --only diagnosis

runs phases 1-2 and ``phase_diagnosis`` alone (no kernel line, no result
line): a quick run of that phase.

    python3 chip_smoke.py --ablate [SOURCE ...]

runs, after phase 1, only the ablation of design constants instead: each
source of ``ABLATIONS`` (default: attention, attention_variants,
meanshift, ccl) built once per variant (``-D`` overrides of the constants
it guards with ``#ifndef``), every variant checked as in phase 3 (the
microbenchmark's variants on its inputs: an entry named "vN: ..." builds
for variant vN only, v5's constants touch v5 only), then the variants
read in turns (median of 6 readings of 20 launches each): the attention
forward pair's flash pass with SDPA's forward and its mean pass; the tool's
variants with the shipped capture pair and SDPA's forward at the
microbenchmark's shape; the mean-shift fixpoint (bf16) and CCL on phase
3's inputs.
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
        "mean: query tiles streamed, none resident": ("MEAN_RESIDENT_BYTES=0",),
    },
    "attention_variants": {
        "as built": (),
        "out pass: 3 ring slots": ("VAR_STAGES=3",),
        "out pass: 5 ring slots": ("VAR_STAGES=5",),
        "mean pass: 3 ring slots": ("VMEAN_STAGES=3",),
        "mean pass: chunks of at most 4 key tiles": ("VMEAN_MAX_CHUNK=4",),
        "mean pass: query tiles streamed, none resident": ("VMEAN_RESIDENT_HEADS=0",),
        # v6's PV as one m64n72k16: 8 KB more per ring slot, so 4 slots leave
        # one block per SM (2 x (115,752 + 1,024 reserved) B > the SM's
        # 233,472 B), 3 slots two
        "v6: one n72 product, 4 ring slots": ("VAR_V6_N72=1",),
        "v6: one n72 product, 3 ring slots": ("VAR_V6_N72=1", "VAR_STAGES=3"),
        # v5's cluster size forced: 1 is the no-split design (34 blocks at the
        # tool's T: below one wave), 4 and 8 beside the host's pick
        "v5: cluster 1": ("V5_CLUSTER=1",),
        "v5: cluster 4": ("V5_CLUSTER=4",),
        "v5: cluster 5": ("V5_CLUSTER=5",),
        "v5: cluster 6": ("V5_CLUSTER=6",),
        "v5: cluster 7": ("V5_CLUSTER=7",),
        "v5: cluster 8": ("V5_CLUSTER=8",),
        "v5: query tiles streamed, none resident": ("V5_RESIDENT_HEADS=0",),
        "v5: sweep 1 with 2 ring slots": ("V5_STAGES=2",),
        # 4 ring slots: still two blocks per SM at 6 heads (sweep 2 sets the size)
        "v5: sweep 1 with 4 ring slots": ("V5_STAGES=4",),
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


# ptxas's registers and spills per kernel of the libraries this run built:
# (source, defines) -> mangled kernel name -> {"registers", "spill_stores", "spill_loads"}
PTXAS: dict = {}


def ptxas_usage(out: str) -> dict:
    """Registers and spill bytes per kernel from ``-Xptxas -v`` output."""
    import re

    usage, name = {}, None
    for line in out.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            usage[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def registers(source: str, kernel: str) -> str:
    """``kernel``'s registers and spills as this run's build of ``source``
    reported them (its name in the anonymous namespace of the source; a
    template's instances each, e.g. ``flash_fwd<64>``)."""
    import re

    found = []
    for mangled, use in PTXAS.get((source, ()), {}).items():
        m = re.search(rf"{len(kernel)}{kernel}(E|I((?:L[ib]\d+E)+)E)", mangled)
        if m:
            targs = ", ".join({"b0": "false", "b1": "true"}.get(a, a[1:]) for a in
                              re.findall(r"L([ib]\d+)E", m.group(2) or ""))
            found.append(f"{kernel}{f'<{targs}>' if targs else ''} {use.get('registers', '?')} "
                         f"registers, spills {use.get('spill_stores', '?')}/"
                         f"{use.get('spill_loads', '?')} B")
    return "; ".join(found) or f"{kernel} registers not read (library built before this run)"


def phase_build(targets=None):
    """Build every kernel source (or each (source, defines) of ``targets``),
    printing ptxas's registers and spills per kernel and its warnings (a
    C7510-C7519 warning: wgmma serialised)."""
    from attentionshift_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(targets)
    dt = time.perf_counter() - t0
    for (src, defines), out in logs.items():
        tag = " ".join((src, *defines))
        PTXAS[(src, tuple(defines))] = ptxas_usage(out)
        for name, use in PTXAS[(src, tuple(defines))].items():
            log(f"[build] {tag}: {name}: {use}")
        for line in out.splitlines():
            if "warning" in line.lower() or "error" in line.lower():
                log(f"[build] {tag}: {line.strip()}")
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
    expect_capture_mean("attention_capture.mean", mean, ref_mean, (q, k, v, PAD_GAP))
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
    expect_capture_mean("attention_capture.tool_input.mean", mean, ref_mean, (tq, tk, tv, None))
    expect("attention_plain.tool_input.out", max_err(out2, ref_out), out_tol, why_out)
    del ref_out, ref_mean, out, mean, out2

    phase_backward_kernels(results, inp)
    phase_head_shape_kernels(results, q.device)
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


def expect_capture_mean(name: str, mean, want, controls=None) -> None:
    """The capture pair's head mean against the plain version's, entry by
    entry, within ``attention.capture_mean_limit`` (one bf16 step of the
    entry, + 2^-126: both sides round one f32 mean; derived in its
    docstring). ``controls`` (q, k, v, gap): the plain mean with the
    temperature off (q x 1.1) and with the last head off must both fail
    the same limit, or the check could not see either."""
    from attentionshift_torch.ops import attention

    over = mean_over(mean, want, attention.capture_mean_limit(want))
    ok = over <= 1.0
    log(f"[check] {name}: max_abs_err {max_err(mean, want):.3e}, worst entry at {over:.3f}x its "
        f"limit (one bf16 step of each entry + 2^-126): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: a mean entry at {over}x its limit")
    if controls is None:
        return
    q, k, v, gap = controls
    h = q.shape[1]
    for what, (cq, ck, cv) in (("temperature off (q x 1.1)", ((q.float() * 1.1).to(q.dtype), k, v)),
                               ("last head off", (q[:, :h - 1], k[:, :h - 1], v[:, :h - 1]))):
        if cq.shape[1] == 0:
            continue
        ctl = attention.attention_reference(cq, ck, cv, gap)[1]
        c_over = mean_over(mean, ctl, attention.capture_mean_limit(ctl))
        log(f"[check] {name} control (plain mean with the {what}): worst entry at "
            f"{c_over:.3f}x its limit, must exceed 1: {'ok' if c_over > 1.0 else 'FAIL'}")
        if not c_over > 1.0:
            raise AssertionError(f"{name}: the mean check cannot see the {what}")
        del ctl


def mean_over(mean, want, limit) -> float:
    """The largest |mean - want| / limit over the entries (<= 1: within)."""
    return float(((mean.float() - want.float()).abs() / limit).max())


def expect_mean(name: str, mean, want, limit) -> None:
    """A variant's mean against its plain version, entry by entry, within
    ``limit`` (``attention_variants.mean_limit``)."""
    over = mean_over(mean, want, limit)
    ok = over <= 1.0
    log(f"[check] {name}: max_abs_err {max_err(mean, want):.3e}, worst entry at {over:.3f}x its "
        f"limit (5.5 bf16 steps of each entry, mean_limit): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: a mean entry at {over}x its limit")


def phase_variant_kernels(results: dict, inp: dict):
    """The five design variants of the attention microbenchmark against
    their plain versions, bf16, no gap: on the microbenchmark's own inputs
    at (1, 6, 4301, 64) (odd T, ragged last tile: the shape every launch
    of the tool has), at (1, 6, 4352, 64) on the bench inputs, and there
    on the clamp input (two shifted log2 logits of one row in (100, 127)).
    ``out`` within 4 bf16 ulps of its largest entry, each mean entry within
    ``mean_limit`` (derived in its docstring). Control: on the clamp input
    the plain version of the other clamp behaviour must exceed both
    limits. The error kept for the kernel table is the one on the
    microbenchmark's inputs. Every variant (no atomics) also gives bitwise
    equal outputs in two calls on the tool's inputs; v5's cluster size at
    that shape is printed."""
    import torch

    from attentionshift_torch.ops import attention_variants as av

    q, k, v = inp["qkv"]
    cases = ((".tool_input", inp["tool_qkv"]), (".bench_input", (q, k, v)),
             (".clamp_input", av.clamp_case(q, k, v)))
    for name, (kernel, number) in av.VARIANTS.items():
        errs = []
        for tag, case in cases:
            want_out, want_mean = av.variant_reference(*case, name)
            out, mean = av.attention_variant(*case, name)
            sync()
            out_tol = bf16_ulps(want_out, 4)
            e_out, e_mean = max_err(out, want_out), max_err(mean, want_mean)
            expect(f"{kernel}{tag}.out", e_out, out_tol,
                   "4 bf16 ulps of the largest |out|: bf16 output, bf16 e in PV")
            expect_mean(f"{kernel}{tag}.mean", mean, want_mean,
                        av.mean_limit(case[0], case[1], name, want_mean))
            errs.append(max(e_out, e_mean))
            del want_out, want_mean
        # still the clamp input: v3's plain version for the clamped kernels, v2's for v3
        other = "v2-bf16e" if name == "v3-nomin" else "v3-nomin"
        ctl_out, ctl_mean = av.variant_reference(*cases[-1][1], other)
        c_out = max_err(out, ctl_out)
        c_mean = mean_over(mean, ctl_mean, av.mean_limit(*cases[-1][1][:2], other, ctl_mean))
        ok = c_out > out_tol and c_mean > 1.0
        log(f"[check] {kernel} control (plain {other} on the clamp input): out {c_out:.3e} must "
            f"exceed {out_tol:.1e}, worst mean entry {c_mean:.3e}x its limit must exceed 1: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel}: the check cannot see the clamp: {c_out}, {c_mean}")
        del ctl_out, ctl_mean, out, mean
        first = av.attention_variant(*inp["tool_qkv"], name)
        second = av.attention_variant(*inp["tool_qkv"], name)
        sync()
        same = torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
        log(f"[check] {kernel}.tool_input: two calls bitwise equal: {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"{kernel}: two calls on the same inputs differ")
        del first, second
        results[kernel] = dict(max_abs_err=errs[0])
    b, h, t, _ = inp["tool_qkv"][0].shape
    if q.is_cuda:
        log(f"[check] attn_v5_batched at {(b, h, t)}: clusters of "
            f"{av.variant_library().attn_v5_cluster(b, h, t)} blocks (attn_v5_cluster)")


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
    cpu16 = build_model("cpu", torch.bfloat16, max_gt=g)
    inp_cpu = slice_inputs(h, w, g, nv, "cpu")
    inp_gpu = tuple(t.to(dev) for t in inp_cpu)
    with torch.no_grad():
        bg = gpu.backbone(inp_gpu[0])
        bc = cpu.backbone(inp_cpu[0])
        b16 = cpu16.backbone(inp_cpu[0])
    # the card's bf16 path against the f32 path, within a relative limit or
    # within 1.5x what bf16 rounding alone gives there, whichever is larger:
    # the CPU's bf16 plain path's own distance from the f32 path is the
    # witness (with the JAX modules' init, q, k, v 2.5x the former
    # N(0, 0.02), the rounding through 12 blocks moves the point
    # coordinates by ~2 % of the largest)
    for key, rel in (("attns", 2e-2), ("last_feat", 5e-2), ("outputs_class", 5e-2),
                     ("outputs_coord", 2e-2)):
        ref = bc[key].float()
        witness = max_err(b16[key].float(), ref)
        expect(f"small.backbone.{key}", max_err(bg[key].cpu(), ref),
               max(rel * max(float(ref.abs().max()), 1e-6), 1.5 * witness),
               f"bf16 card path vs f32 CPU path through 12 blocks: relative to the largest "
               f"value, or 1.5x the bf16 CPU plain path's own distance {witness:.3e}")
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
        store[name] = ([a.detach().clone() if torch.is_tensor(a) else a for a in args],
                       dict(kwargs))
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
    synchronize), then one profiled call and its host reads."""
    import torch

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
    events = []
    avgs, _ = profile_slice(run, ms_img, what="inference call", events=events)
    host = torch.autograd.DeviceType.CPU
    reads = sum(e.count for e in avgs if e.key == "aten::_local_scalar_dense"
                and e.device_type == host)
    log(f"[infer] one profiled simple_test image: {reads} host reads of a scalar, "
        f"{host_reads_under(events, 'nms.while_loop')} of them in the NMS while_loop")
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
    return dict(base=base, ts=ts, launches=launches, root=root,
                split=os.path.join(root, "ImageSets", "Segmentation", "val.txt"),
                dump=os.path.join(tmp, f"single-{INFER_SCORE_THR}.pkl"))


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
        events = []
        avgs, busy = profile_slice(lambda: run(1), ms_img, what=f"{mode} eval image",
                                   events=events)
        host = torch.autograd.DeviceType.CPU
        count = lambda key: sum(e.count for e in avgs if e.key == key and e.device_type == host)  # noqa: E731
        log(f"[eval] one profiled {mode} image: {count('cudaStreamSynchronize')} "
            f"cudaStreamSynchronize, {count('aten::_local_scalar_dense')} host reads of a scalar, "
            f"{host_reads_under(events, 'nms.while_loop')} of them in the NMS while_loop, "
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


def mae_state_dict(depth: int = 12, d: int = EMBED, patch: int = 16, qkv_scale: float = 1.0) -> dict:
    """A seeded random MAE ViT-S encoder ``state_dict`` under MAE's key
    names, with its final norm (which the graft leaves out); the attention's
    q, k, v projections ``qkv_scale`` times larger (``SHARP_QKV``)."""
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
        sd[f"blocks.{i}.attn.qkv.weight"] *= qkv_scale
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


def gradient_tops(store: dict, key=lambda name: name.split(".", 1)[0]):
    """Patch ``Optimizer.step`` to keep the largest |gradient| per ``key``
    of a parameter name (its submodule by default; 0 for a None gradient)."""
    from unittest import mock

    from attentionshift_torch.train.optim import Optimizer

    inner = Optimizer.step

    def step(self, grads):
        for name, g in zip(self.names, grads):
            top = 0.0 if g is None else float(g.float().abs().max())
            store[key(name)] = max(store.get(key(name), 0.0), top)
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
    return dict(argv=argv, opts=opts, cfg=cfg, work=work, tmp=tmp, out=out, root=root, node=node)


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


REFINE_STEPS = 4  # micro-steps per invocation: batch 2, accumulate_steps 1
REFINE_LOSS_KEYS = {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "rcnn_acc", "loss_bbox",
                    "loss_mask"}
# configs/mrcnn_refine_voc.py as it is: the phase checks the CLI built this
REFINE_AS_CONFIGURED = dict(depths=(3, 4, 6, 3), batch_size=2, train_scales=[(800, 1333)],
                            num_proposals=1000, rcnn_samples=512, mask_sample_cap=128,
                            base_lr=0.0025)


def torchvision_resnet50_state(seed: int = 7) -> dict:
    """A seeded random torchvision ResNet-50 ``state_dict`` under
    torchvision's key names: He-normal conv weights, BN affines near the
    identity with positive running variances (``calibrate_frozen_bn`` sets
    them from the data), and the classifier and ``num_batches_tracked``
    entries that the graft drops."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.randn(cout, cin, k, k, generator=gen) * (2.0 / (cin * k * k)) ** 0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.05 * torch.randn(c, generator=gen)
        sd[f"{name}.bias"] = 0.05 * torch.randn(c, generator=gen)
        sd[f"{name}.running_mean"] = 0.05 * torch.randn(c, generator=gen)
        sd[f"{name}.running_var"] = 0.75 + 0.5 * torch.rand(c, generator=gen)
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2**stage
        for b in range(blocks):
            p = f"layer{stage + 1}.{b}"
            conv(f"{p}.conv1", f, cin if b == 0 else 4 * f, 1)
            conv(f"{p}.conv2", f, f, 3)
            conv(f"{p}.conv3", 4 * f, f, 1)
            for c, width in ((1, f), (2, f), (3, 4 * f)):
                bn(f"{p}.bn{c}", width)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
        cin = 4 * f
    sd["fc.weight"] = 0.01 * torch.randn(1000, cin, generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def calibrate_frozen_bn(sd: dict, dev) -> dict:
    """``sd`` with every BN's running mean and variance set to the batch
    statistics of its input in one forward of the port's ResNet-50 on
    noise images, each BN calibrated before the next sees its output: a
    random backbone normalised as a trained one is, so that the features,
    the RPN's deltas and the proposals' sizes (hence their FPN levels)
    stay in a trained detector's range."""
    import torch

    from attentionshift_torch.models.resnet import FrozenBN, ResNet

    net = ResNet(depths=(3, 4, 6, 3)).to(dev)
    net.load_state_dict({k: v for k, v in sd.items() if k in net.state_dict()}, strict=True)

    def stats(module, inputs):
        x = inputs[0]
        module.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        module.running_var.copy_(x.var(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(stats) for m in net.modules() if isinstance(m, FrozenBN)]
    gen = torch.Generator(device=dev).manual_seed(11)
    with torch.no_grad():
        net(torch.randn(2, 512, 512, 3, device=dev, generator=gen))
    for h in hooks:
        h.remove()
    return dict(sd, **{k: v.cpu() for k, v in net.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))})


def phase_refine_reference(dev):
    """The refinement stage's TINY Mask R-CNN train step (f32, ResNet depths
    (1, 1, 1, 1), batch 2 at 128 x 128) on the card against the same step
    on the CPU (the plain path that the CPU tests hold against the JAX
    package), from the same seeded init, batch and draws: losses within
    2e-4 of max(1, |loss|), sampled positives equal, every gradient within
    2e-3 of its tensor's largest entry; no hand-written kernel launched."""
    import numpy as np
    import torch

    from attentionshift_torch.models.mask_rcnn import MaskRCNN
    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.train import TrainState, build_sgd_optimizer, make_refine_train_step

    kw = dict(num_classes=5, num_proposals=50, rpn_nms_pre=100, rcnn_samples=32,
              mask_sample_cap=8, depths=(1, 1, 1, 1), test_max_per_img=10)
    rs = np.random.RandomState(1)
    boxes = np.asarray([[[8, 8, 60, 70], [50, 40, 120, 100], [10, 60, 50, 126], [0, 0, 0, 0]],
                        [[20, 4, 90, 50], [64, 64, 127, 127], [4, 30, 40, 90], [0, 0, 0, 0]]],
                       np.float32)
    masks = np.zeros((2, 4, 32, 32), np.uint8)
    for i in range(2):
        for j, (x1, y1, x2, y2) in enumerate(boxes[i, :3].astype(int) // 4):
            masks[i, j, y1:y2, x1:x2] = 1
    batch = dict(img=torch.from_numpy(rs.randn(2, 128, 128, 3).astype(np.float32)),
                 gt_boxes=torch.from_numpy(boxes), gt_masks=torch.from_numpy(masks),
                 gt_labels=torch.tensor([[1, 2, 3, 0], [4, 0, 2, 0]], dtype=torch.int32),
                 gt_valid=torch.tensor([[True, True, True, False]] * 2),
                 img_wh=torch.tensor([[128.0, 128.0]] * 2))
    gen = torch.Generator().manual_seed(5)
    n_anchors = 3 * sum(s * s for s in (32, 16, 8, 4, 2))
    draws = [dict(rpn_u_pos=torch.rand(n_anchors, generator=gen),
                  rpn_u_neg=torch.rand(n_anchors, generator=gen),
                  rcnn_u_pos=torch.rand(54, generator=gen), rcnn_u_neg=torch.rand(54, generator=gen),
                  mask_u=torch.rand(32, generator=gen)) for _ in range(2)]

    def run(device):
        model = MaskRCNN(device=device, **kw).init_weights(seed=0)
        opt = build_sgd_optimizer(model, steps_per_epoch=10)
        seen, inner, pos, fwd = {}, opt.step, [], model.forward
        opt.step = lambda grads: (seen.update({n: g.detach().cpu() for n, g in
                                               zip(opt.names, grads)}), inner(grads))[1]
        model.forward = lambda *a, **k: (lambda out: (pos.append(out[1]["pos"].cpu()), out)[1])(
            fwd(*a, **k))
        reset_launches()
        _, metrics = make_refine_train_step(model)(
            TrainState.create(model, opt), {k: v.to(device) for k, v in batch.items()},
            draws=draws)
        sync()
        return {k: float(v) for k, v in metrics.items()}, seen, pos[0], launch_counts()

    card, card_grads, card_pos, launched = run(dev)
    host, host_grads, host_pos, _ = run(torch.device("cpu"))
    if any(launched.values()):
        raise AssertionError(f"the TINY refine step launched a hand-written kernel: {launched}")
    if set(card) != set(host) or not torch.equal(card_pos, host_pos) or not card_pos.any():
        raise AssertionError(f"refine step card vs CPU: keys {sorted(card)} vs {sorted(host)}, "
                             f"positives equal {torch.equal(card_pos, host_pos)}")
    worst = max(abs(card[k] - v) / max(1.0, abs(v)) for k, v in host.items())
    expect("small.refine.losses", worst, 2e-4,
           "f32 card vs f32 CPU, relative to max(1, |loss|), the train step's tolerance")
    worst = max(max_err(card_grads[n], g) / max(float(g.abs().max()), 1e-30)
                for n, g in host_grads.items())
    expect("small.refine.grads", worst, 2e-3,
           "every trainable gradient, relative to its tensor's largest entry")
    log(f"[small] refine step card vs CPU: {len(host)} metrics, {len(host_grads)} gradients, "
        f"{int(card_pos.sum())} sampled positives equal; no hand-written kernel launched")


def phase_refine_cli(tc: dict, smi: str) -> dict:
    """The refinement stage (AttnShift-dagger) through the port's entry
    points at the full width of ``configs/mrcnn_refine_voc.py`` as it is
    (ResNet-50-FPN Mask R-CNN, f32, batch 2 at (800, 1333), 1000 proposals,
    512 RCNN samples, 128 mask RoIs, SGD 0.0025), chained on the pseudo-label
    json that the dump phase wrote, with a synthetic torchvision ResNet-50
    checkpoint (BN statistics calibrated) as ``pretrained``. ``tools.train`` invocation 1 runs 4
    micro-steps and saves ``epoch_1``; invocation 2 auto-resumes for 4 more
    and saves ``epoch_2``; ``tools.test`` evaluates ``epoch_2`` single-scale
    and with ``--aug-test`` over the 2 val images. Checks the graft tensor by
    tensor, finite losses, a gradient for and a move of every trainable
    parameter, the frozen stem, ``layer1`` and every FrozenBN buffer bitwise
    unchanged, the optimizer's count, the metric dicts, and that no
    hand-written kernel launches anywhere on the path; then the times."""
    import math
    import statistics

    import torch

    from attentionshift_torch.eval.aug_test import AugTester
    from attentionshift_torch.eval.runner import evaluate
    from attentionshift_torch.models.mask_rcnn import MaskRCNN
    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.tools import test as test_cli
    from attentionshift_torch.tools import train as cli

    t_phase = time.perf_counter()
    tmp, root = tc["tmp"], tc["root"]
    sd = calibrate_frozen_bn(torchvision_resnet50_state(), torch.device(
        "cuda" if torch.cuda.is_available() else "cpu"))
    pretrained = os.path.join(tmp, "resnet50_torchvision.pth")
    torch.save(sd, pretrained)
    cfg = os.path.join(HERE, "configs", "mrcnn_refine_voc.py")
    work = os.path.join(tmp, "refine_work")
    val = [f"data.val.split_file={root}/ImageSets/Segmentation/val.txt", f"data.val.voc_root={root}"]
    opts = ["--cfg-options", f"data.train.ann_file={os.path.join(tmp, 'pseudo_train.json')}",
            f"data.train.img_prefix={tc['node']['img_prefix']}", *val, f"pretrained={pretrained}",
            "schedule.total_epochs=2", "runtime.log_interval=1"]
    argv = [cfg, "--work-dir", work, "--max-steps", str(REFINE_STEPS), "--no-validate"] + opts

    run = cli.build(cli.parse_args(argv))
    c, m = run.cfg, run.model
    built = dict(depths=m.backbone.depths, batch_size=int(c.data.batch_size),
                 train_scales=[tuple(x) for x in c.data.train_scales],
                 num_proposals=m.num_proposals, rcnn_samples=m.rcnn_samples,
                 mask_sample_cap=m.mask_sample_cap, base_lr=float(c.optimizer.base_lr))
    if not (isinstance(m, MaskRCNN) and built == REFINE_AS_CONFIGURED
            and run.state.optimizer.rule == "sgd"
            and all(p.dtype == torch.float32 for p in m.parameters())):
        raise AssertionError(f"the refine phase runs configs/mrcnn_refine_voc.py as it is: {built}")
    bb = m.backbone.state_dict()
    for key, t in bb.items():
        if not torch.equal(t.cpu(), sd[key]):
            raise AssertionError(f"ResNet graft: backbone.{key} differs from the checkpoint's")
    log(f"[refine-cli] torchvision ResNet-50 graft before the first step: all {len(bb)} backbone "
        f"tensors equal to the checkpoint's (fc and num_batches_tracked dropped)")
    init = {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
    trainable = {n for n, p in m.named_parameters() if p.requires_grad}
    del run, m, bb
    out = {}
    for inv in (1, 2):
        calls, grads = [], {}
        torch.cuda.reset_peak_memory_stats()
        with counting(cli, "train_step", calls), gradient_tops(grads, key=lambda name: name):
            reset_launches()
            stats = cli.main(argv)
            sync()
        total = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        if len(calls) != REFINE_STEPS or any(nonzero(cl["launches"]) for cl in calls) or any(
                total.values()):
            raise AssertionError(f"refine CLI {inv}: {len(calls)} micro-steps, launches {total}")
        vals = stats["metrics"]
        if set(vals) != REFINE_LOSS_KEYS | {"loss_total"} or not all(map(math.isfinite,
                                                                         vals.values())):
            raise AssertionError(f"refine CLI {inv}: metrics {vals}")
        with open(os.path.join(work, "train_log.jsonl")) as f:
            if len(f.readlines()) != inv * REFINE_STEPS:
                raise AssertionError("refine train_log.jsonl: wrong record count")
        ckpt = torch.load(os.path.join(work, f"epoch_{inv}"), map_location="cpu", weights_only=True)
        o = ckpt["opt_state"]
        if (ckpt["epoch"], ckpt["step"], o["rule"], o["count"], o["nu"]) != (
                inv, inv * REFINE_STEPS, "sgd", inv * REFINE_STEPS, None):
            raise AssertionError(f"refine epoch_{inv}: epoch {ckpt['epoch']}, step {ckpt['step']}, "
                                 f"rule {o['rule']}, count {o['count']}")
        if set(grads) != trainable or not all(v > 0 for v in grads.values()):
            raise AssertionError(f"refine CLI {inv}: no gradient for "
                                 f"{sorted(n for n in trainable if not grads.get(n, 0) > 0)[:5]}")
        frozen_moved = [k for k, v in ckpt["params"].items()
                        if k not in trainable and not torch.equal(v, init[k])]
        still = [k for k in trainable if torch.equal(ckpt["params"][k], init[k])]
        bad = [k for k, v in ckpt["params"].items() if not bool(torch.isfinite(v).all())]
        if frozen_moved or still or bad:
            raise AssertionError(f"refine epoch_{inv}: frozen moved {frozen_moved[:5]}, trainable "
                                 f"unmoved {still[:5]}, not finite {bad[:5]}")
        _, batch, epoch = calls[0]["args"]
        for cl in calls:  # let the invocation's run go
            cl.pop("args"), cl.pop("out")
        out[inv] = dict(stats=stats, peak=peak, total=total, batch=batch, epoch=epoch)
        log(f"[refine-cli] {inv}: {REFINE_STEPS} micro-steps, last metrics "
            f"{({k: round(v, 4) for k, v in sorted(vals.items())})}; every one of the "
            f"{len(trainable)} trainable tensors got a gradient and moved; the "
            f"{len(init) - len(trainable)} frozen tensors (stem, layer1, every FrozenBN buffer) "
            f"bitwise unchanged; opt.count {o['count']}; launches {nonzero(total) or 'none'}")
    s2 = out[2]["stats"]
    if s2["resumed"] != os.path.join(work, "epoch_1") or s2["start_epoch"] != 1:
        raise AssertionError(f"refine invocation 2 did not resume from epoch_1: {s2['resumed']}")
    log("[refine-cli] 2: resumed from epoch_1 at epoch 1")

    ckpt = os.path.join(work, "epoch_2")
    evals = {}
    for mode, extra in (("single", []), ("aug", ["--aug-test"])):
        res, got, lines = run_cli([cfg, ckpt, "--cfg-options", *val] + extra, set())
        if sorted(res) != ["mAP@0.25", "mAP@0.5", "mAP@0.75"] or not all(
                map(math.isfinite, res.values())):
            raise AssertionError(f"refine eval {mode}: {res}")
        if any(got.values()):
            raise AssertionError(f"refine eval {mode} launched a hand-written kernel: {got}")
        evals[mode] = got
        log(f"[refine-eval] {mode}: {res}; no hand-written kernel launched")

    # times (host clock unless said), each beside the card
    for inv in (1, 2):
        st = out[inv]["stats"]
        log(f"[time] refine train CLI {inv} ({smi}): "
            f"{statistics.median(st['step_ms'][1:]):.2f} ms per micro-step at batch 2 (median of "
            f"steps 2-{len(st['step_ms'])}, host clock; first {st['step_ms'][0]:.2f}); waiting on "
            f"the loader {[round(x, 2) for x in st['wait_ms']]} ms; peak "
            f"{out[inv]['peak']:.0f} MiB allocated; checkpoint save {st['save_s'][0]:.3f} s")
    run = cli.build(cli.parse_args(argv + ["--resume-from", ckpt, "--no-auto-resume"]))
    batch, epoch = out[2]["batch"], out[2]["epoch"]
    cli.train_step(run, batch, epoch)
    sync()
    _, busy = profile_slice(lambda: cli.train_step(run, batch, epoch),
                            statistics.median(out[2]["stats"]["step_ms"][1:]),
                            what=f"refine micro-step (batch 2; {smi})")
    log(f"[refine-cli] one profiled micro-step: busy "
        f"{'not measured' if busy is None else f'{busy:.1%}'} ({smi})")
    del run
    args = test_cli.parse_args([cfg, ckpt, "--cfg-options", *val])
    tcfg, model, dataset, _ = test_cli.build(args)
    for mode in ("single", "aug"):
        aug = AugTester(model, scales=test_cli.AUG_SCALES, flip=True) if mode == "aug" else None
        evaluate(model, dataset, test_scale=tuple(tcfg.data.test_scale), limit=1, aug_tester=aug,
                 num_classes=20, verbose=False)  # warm
        sync()
        t0 = time.perf_counter()
        evaluate(model, dataset, test_scale=tuple(tcfg.data.test_scale), aug_tester=aug,
                 num_classes=20, verbose=False)
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / len(dataset)
        log(f"[time] refine eval {mode}{' (6 scales x flip)' if aug else ''} ({smi}): {ms:.2f} "
            f"ms/img over the {len(dataset)} val images (host clock, mask pasting and scoring "
            f"included)")
    log(f"[time] refine phase ({smi}): {time.perf_counter() - t_phase:.1f} s wall (host clock: "
        f"the graft check, 2 x {REFINE_STEPS} micro-steps, the CLI evaluations, the timings)")
    return dict(train={k: out[1]["total"][k] + out[2]["total"][k] for k in out[1]["total"]},
                eval={k: evals["single"][k] + evals["aug"][k] for k in evals["single"]})


# ------------------------------------------------------ the train variants
COCO_CLI_STEPS = 4  # micro-steps: batch 2, accumulate_steps 2
# check_meanshift_on: reordered plain versions drawn at a time beside the f64
# one, and the most drawn for one check
MS_WITNESS_ORDERS, MS_WITNESS_MAX = 8, 64
COCO_SIZE = (480, 640)  # (h, w) of the synthetic COCO images
# instances per image: half of the images above 20, one at max_gt = 40
COCO_INSTANCES = (6, 24, 12, 36, 9, 30, 16, 40)
# COCO's 80 category ids, with its gaps
COCO_CAT_IDS = tuple(i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
# per micro-step at the config's batch of 2: every block captured
# (cam_layer = 12), the checkpoint recompute of every block through the
# plain kernel, a backward pair per block, CCL (12 x 40 = 480 planes) and
# mean-shift (G = 40) once per image
COCO_CLI_LAUNCHES = {"attention_capture": 12, "attention_plain": 12, "attention_bwd_dq": 12,
                     "attention_bwd_dkv": 12, "ccl_batch": 2, "meanshift_fixpoint": 2}
# the teacher's backbone forward per micro-step: 7 capture + 5 plain blocks
# for the batch, no backward; the student then runs without the capture: 12
# plain blocks and their 12 recomputes
TEACHER_LAUNCHES = {"attention_capture": CAM_LAYERS, "attention_plain": 12 - CAM_LAYERS}
TS_STUDENT_LAUNCHES = {"attention_plain": 24, "attention_bwd_dq": 12, "attention_bwd_dkv": 12,
                       "ccl_batch": 2, "meanshift_fixpoint": 2}
VARIANT_CLI_STEPS = 2
VITB_EMBED, VITB_HEADS = 768, 12  # configs/attnshift_coco_vitb.py
RP_KEYS = {"loss_rp_border", "loss_rp_chamfer_sem", "loss_rp_chamfer_contour", "loss_rp_cls"}
# The COCO paths' synthetic MAE checkpoints: q, k, v 10x the N(0, 0.02) init,
# so that attention logits reach ~15 and a point token's attention picks out
# patches of one content. Stage C then finds parts for nearly every instance
# of the synthetic tree; at 1x the rollout CAMs are flat, the candidate boxes
# are the whole image, and few instances get a part (loss_rp_chamfer_contour
# then reads the reference's 5e8 for each object without one).
SHARP_QKV = 10.0
CONTOUR_SENTINEL = 5e8  # what an object with contour points and no valid part adds
COCO_VAL_KEYS = ["AP", "AP50", "AP75"]


def coco_point_tree(root: str) -> dict:
    """Landscape JPEGs of a grid of elliptic instances (``COCO_INSTANCES``
    per image) and one COCO json over COCO's 80 category ids: per instance
    a point at its center (``COCOPointDataset``), a 12-gon polygon, its
    area and box (``COCOEvalDataset``). Returns the paths."""
    import numpy as np
    from PIL import Image

    rs = np.random.RandomState(3)
    h, w = COCO_SIZE
    yy, xx = np.mgrid[:h, :w]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    t = np.linspace(0.0, 2.0 * np.pi, 12, endpoint=False)
    images, annotations = [], []
    for i, n in enumerate(COCO_INSTANCES):
        cols = int(np.ceil(np.sqrt(n * w / h)))
        rows = -(-n // cols)
        img = rs.rand(h, w, 3) * 60 + 40
        for j in range(n):
            r, c = divmod(j, cols)
            ax, ay = 0.35 * w / cols, 0.35 * h / rows
            cx = (c + 0.5) * w / cols + rs.uniform(-2, 2)
            cy = (r + 0.5) * h / rows + rs.uniform(-2, 2)
            m = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 < 1.0
            img[m] += 120.0 * np.eye(3)[j % 3]
            poly = np.stack([cx + ax * np.cos(t), cy + ay * np.sin(t)], 1).reshape(-1)
            annotations.append(dict(
                id=len(annotations), image_id=i, category_id=COCO_CAT_IDS[(7 * i + 3 * j) % 80],
                point=[float(cx), float(cy)], segmentation=[[float(v) for v in poly]],
                area=float(m.sum()), bbox=[float(cx - ax), float(cy - ay), 2 * ax, 2 * ay],
                iscrowd=0))
        name = f"{i:012d}.jpg"
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(os.path.join(root, "images", name))
        images.append(dict(id=i, file_name=name, width=w, height=h))
    ann = os.path.join(root, "instances_points.json")
    with open(ann, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=c, name=f"cat{c}") for c in COCO_CAT_IDS]), f)
    return dict(ann_file=ann, img_prefix=os.path.join(root, "images"))


def fitted(store: list):
    """Patch ``tools.train.fit`` to keep each run it fits, with a CPU copy
    of the parameters and buffers the run starts from."""
    from unittest import mock

    from attentionshift_torch.tools import train as cli

    inner = cli.fit

    def fit(run):
        store.append((run, {k: v.detach().cpu().clone() for k, v in run.model.state_dict().items()}))
        return inner(run)

    return mock.patch.object(cli, "fit", fit)


def kernel_inputs_of(store: dict):
    """``recording`` of the CCL, mean-shift and capture-attention wrappers,
    as their callers import them."""
    import contextlib

    from attentionshift_torch.models import layers
    from attentionshift_torch.pseudo import engine, meanshift

    stack = contextlib.ExitStack()
    for module, name in ((engine, "connected_components_batch"),
                         (meanshift, "cosine_shift_fixpoint"), (layers, "attention_with_capture")):
        stack.enter_context(recording(module, name, store))
    return stack


def cascade_parts(store: list):
    """Patch ``AttnShiftDetector._cascade`` to keep, per call, (instances
    with a valid Stage-C part, valid instances)."""
    from unittest import mock

    from attentionshift_torch.models import AttnShiftDetector

    inner = AttnShiftDetector._cascade

    def cascade(self, rp_level, out, patch_hw, seed, protos, gt_valid, *rest):
        v = gt_valid.bool()
        store.append((int((seed["semantic_centers_valid"].any(-1) & v).sum()), int(v.sum())))
        return inner(self, rp_level, out, patch_hw, seed, protos, gt_valid, *rest)

    return mock.patch.object(AttnShiftDetector, "_cascade", cascade)


def check_parts(tag: str, parts: list, vals: dict) -> None:
    """Most instances of every micro-step with a Stage-C part, so that the
    RepPoints losses measure geometry: ``loss_rp_chamfer_sem`` > 0 and
    ``loss_rp_chamfer_contour`` below a quarter of the sentinel."""
    share = min(a / max(b, 1) for a, b in parts)
    log(f"[{tag}] instances with a valid part per micro-step {parts}")
    if share < 0.75 or not (vals["loss_rp_chamfer_sem"] > 0
                            and vals["loss_rp_chamfer_contour"] < CONTOUR_SENTINEL / 4):
        raise AssertionError(f"{tag}: instances with a part {parts}, last losses {vals}")


def check_meanshift_on(tag: str, margs, mkw: dict) -> None:
    """The mean-shift kernel against its plain version on a path's own
    inputs, in the path's operand type and in f32. One iteration
    (``n_shift`` 1): every entry within ``meanshift_kernel.one_step_limit``
    (derived in its docstring). The path's own ``n_shift``: every instance
    by ``meanshift_kernel.fixpoint_verdict``, within max(floor, 2 x the
    plain version's own spread under reordered sums (f64, then orders of N
    and D, ``MS_WITNESS_ORDERS`` at a time up to ``MS_WITNESS_MAX``)) or
    within the floor of one such witness; floor 1e-4 (f32) or phase 3's
    2e-3 (bf16 operands). On a path's inputs the fixpoint can be
    ill-conditioned: an image's features are nearly parallel, so
    tau = 1 - density gets small, each logit sim / (temp * tau) large, and
    one rounding of a weight moves the next iteration, in the plain version
    as much as in the kernel. A control, the plain version with the
    temperature 10 % off, has to fail some instance against the same
    witnesses (its prototypes alone: its similarities put equal)."""
    import torch

    from attentionshift_torch.ops import meanshift_kernel

    prot0, mask, f = margs[:3]
    kw = {k: v for k, v in mkw.items() if k != "lib"}
    n_shift = kw.pop("n_shift", 10)
    temp = kw.setdefault("temp", 0.1)
    path_dtype = kw.get("matmul_dtype")

    def plain(p, m, ff, n):
        return meanshift_kernel.cosine_shift_batch(p, ff[None] * m[..., None], ff, n_shift=n, **kw)

    for mm in dict.fromkeys((path_dtype, None)):
        kw["matmul_dtype"] = mm
        name = f"{tag}.meanshift_fixpoint.{'f32' if mm is None else 'bf16'}"
        got = meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, n_shift=1, **kw)
        want = plain(prot0, mask, f, 1)
        lim = meanshift_kernel.one_step_limit(prot0, mask, f, **kw)
        ratios = [((a - b).abs() / (c + 1e-30)) for a, b, c in zip(got, want, lim)]
        log(f"[check] {name}.one_iteration: largest deviation {max_err(got[0], want[0]):.3e} "
            f"(prototypes), {max_err(got[1], want[1]):.3e} (sim); median limit "
            f"{float(lim[0].median()):.3e} / {float(lim[1].median()):.3e}; worst entry at "
            f"{tuple(int(i) for i in torch.nonzero(ratios[0] == ratios[0].max())[0])} / "
            f"{tuple(int(i) for i in torch.nonzero(ratios[1] == ratios[1].max())[0])}")
        expect(f"{name}.one_iteration (worst entry / its limit)",
               max(float(r.max()) for r in ratios), 1.0,
               "one_step_limit: bf16 steps of the weights and prototypes, near-ties of the "
               "hard assignment, f32 sums")
        floor = 1e-4 if mm is None else 2e-3
        got = meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, n_shift=n_shift, **kw)
        want = plain(prot0, mask, f, n_shift)
        off = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f,
                                                  n_shift=n_shift, **dict(kw, temp=1.1 * temp))
        v, ctl = meanshift_kernel.fixpoint_verdict(
            [got, (off[0], want[1])], prot0, mask, f, floor, n_shift=n_shift,
            orders=MS_WITNESS_ORDERS, max_orders=MS_WITNESS_MAX, **kw)
        log(f"[check] {name} at n_shift {n_shift}: per instance (kernel's deviation, the "
            f"witnesses' spread, the nearest witness), {v['witnesses']} witnesses: "
            f"{[tuple(round(float(x[i]), 5) for x in (v['dev'], v['spread'], v['near'])) for i in range(len(v['dev']))]}; "
            f"{int((v['dev'] <= floor).sum())} of {len(v['dev'])} instances within the floor "
            f"{floor:g}, {int((v['spread'] <= floor).sum())} whose witnesses stay within it, "
            f"{int((v['ok'] & (v['dev'] > v['limit'])).sum())} passed by a witness within it; "
            f"the control (temperature 10 % off, its prototypes) fails {int((~ctl['ok']).sum())}")
        expect(f"{name} at n_shift {n_shift} (worst instance / its limit)",
               float(torch.where(v["ok"], 0.0, v["dev"] / v["limit"]).max()), 1.0,
               "max(floor, 2 x the plain version's spread under reordered sums), or within "
               "the floor of a reordered plain version")
        if bool(ctl["ok"].all()):
            raise AssertionError(f"{name}: the temperature control passes every instance")


def check_kernels_on(tag: str, handed: dict) -> dict:
    """CCL, mean-shift and the capture pair against their plain versions on
    the inputs a path handed them (each of the three that it handed), with
    phase 3's tolerances; returns the shapes they had."""
    import torch

    from attentionshift_torch.ops import attention, ccl

    shapes = {}
    if "connected_components_batch" in handed:
        (masks, *rest), kw = handed["connected_components_batch"]
        iters = kw.get("max_iters", rest[0] if rest else 256)
        expect(f"{tag}.ccl_batch", max_err(ccl.connected_components_batch(masks, iters),
                                           ccl.connected_components(masks, iters)), 0.0,
               "integer labels: exact")
        shapes["ccl_planes"] = tuple(masks.shape)
    if "cosine_shift_fixpoint" in handed:
        margs, mkw = handed["cosine_shift_fixpoint"]
        prot0, mask, f = margs[:3]
        check_meanshift_on(tag, margs, mkw)
        shapes["meanshift"] = dict(G=prot0.shape[0], K=prot0.shape[1], N=f.shape[0],
                                   D=f.shape[1], bf16=mkw.get("matmul_dtype") == torch.bfloat16)
    if "attention_with_capture" in handed:
        (q, k, v, *pad), akw = handed["attention_with_capture"]
        pad = akw.get("pad_interval", pad[0] if pad else None)
        ref_out, ref_mean = attention.attention_reference(q, k, v, pad)
        out, mean = attention.attention_with_capture(q, k, v, pad)
        expect(f"{tag}.attention_capture.out", max_err(out, ref_out), bf16_ulps(ref_out, 4),
               "4 bf16 ulps of the largest |out|: bf16 output and bf16 probabilities in PV")
        expect_capture_mean(f"{tag}.attention_capture.mean", mean, ref_mean)
        shapes.update(attention=tuple(q.shape), pad=pad)
    sync()
    log(f"[{tag}] kernels on this path's own inputs: {shapes}")
    return shapes


def run_train_cli(argv, per_step: dict, steps: int, extra_total: dict | None = None,
                  patches=()):
    """``tools.train.main(argv)`` in this process with the launch counts at
    0 just before; each micro-step's launches must be ``per_step`` and the
    invocation's its multiple plus ``extra_total``. Returns (stats, the
    fitted run and its initial state, the per-step calls, the invocation's
    launches, the submodules' largest |gradient|, peak MiB)."""
    import contextlib

    import torch

    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.tools import train as cli

    calls, grads, runs = [], {}, []
    want_step = {k: 0 for k in launch_counts()}
    want_step.update(per_step)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for p in (counting(cli, "train_step", calls), gradient_tops(grads), fitted(runs), *patches):
            stack.enter_context(p)
        reset_launches()
        stats = cli.main(argv)
        sync()
    total = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    got = [cl["launches"] for cl in calls]
    if len(got) != steps or any(d != want_step for d in got):
        raise AssertionError(f"{argv[0]}: launches per micro-step {got} != {want_step}")
    want = {k: steps * v for k, v in want_step.items()}
    for k, v in (extra_total or {}).items():
        want[k] += v
    if total != want:
        raise AssertionError(f"{argv[0]}: launches {total} != {want}")
    return stats, runs[0], calls, total, grads, peak


def log_step_times(tag: str, stats: dict, peak: float, smi: str) -> None:
    import statistics

    ms = stats["step_ms"]
    rest = f"median of steps 2-{len(ms)} {statistics.median(ms[1:]):.2f} ms, " if len(ms) > 1 else ""
    log(f"[time] {tag}: {rest}first {ms[0]:.2f} ms per micro-step at batch 2 (host clock, losses "
        f"read back each step); waiting on the loader {[round(x, 2) for x in stats['wait_ms']]} "
        f"ms; peak {peak:.0f} MiB allocated; {smi}")


def phase_coco_cli(smi: str) -> dict:
    """``configs/attnshift_coco.py`` as it is (ViT-S 384/12/6, 80 classes,
    batch 2, accumulate_steps 2, ``max_gt`` 40, every block captured, the
    RepPoints head, 11 train scales 480-800 x 1333, brightness jitter,
    remat and drop path) through ``tools.train`` on a synthetic COCO tree,
    with a synthetic MAE ViT-S checkpoint of sharp attention
    (``SHARP_QKV``) as its ``pretrained``: 4 micro-steps, ``epoch_1``
    saved, 2 val images through ``COCOEvalDataset``. Checks the config, the
    launches per micro-step, the losses (``loss_rp_*`` among them, most
    instances with a Stage-C part: ``check_parts``), a gradient in and a move of
    every submodule and of ``reppoints_head_0``, G = 40 filled, the val
    metrics; CCL, mean-shift and the capture pair against their plain
    versions on the inputs this path handed them; times, peak memory and
    one profiled micro-step."""
    import atexit
    import math
    import shutil
    import statistics
    import tempfile

    import torch

    from attentionshift_torch.tools import train as cli

    tmp = tempfile.mkdtemp(prefix="chip_smoke_coco_")
    atexit.register(shutil.rmtree, tmp, True)
    node = coco_point_tree(os.path.join(tmp, "coco"))
    mae = os.path.join(tmp, "mae_pretrain_vit_small.pth")
    torch.save({"model": mae_state_dict(qkv_scale=SHARP_QKV)}, mae)
    opts = ["--cfg-options", f"data.train.ann_file={node['ann_file']}",
            f"data.train.img_prefix={node['img_prefix']}", f"data.val.ann_file={node['ann_file']}",
            f"data.val.img_prefix={node['img_prefix']}", "schedule.total_epochs=1",
            "runtime.log_interval=1", "schedule.warmup_iters=2"]
    work = os.path.join(tmp, "work")
    argv = [os.path.join(HERE, "configs", "attnshift_coco.py"), "--work-dir", work,
            "--max-steps", str(COCO_CLI_STEPS), "--validate-limit", str(TRAIN_CLI_VAL)] + opts + [
                f"pretrained={mae}"]
    handed: dict = {}
    parts: list = []
    stats, (run, init), calls, total, grads, peak = run_train_cli(
        argv, COCO_CLI_LAUNCHES, COCO_CLI_STEPS,
        {"attention_plain": SINGLE_FLASH_PER_IMAGE * TRAIN_CLI_VAL},
        patches=(kernel_inputs_of(handed), cascade_parts(parts)))
    c, m = run.cfg, run.model
    if not (int(c.data.batch_size) == 2 and int(c.optimizer.accumulate_steps) == 2
            and len(c.data.train_scales) == 11 and tuple(c.data.train_scales[0]) == (480, 1333)
            and int(c.data.max_gt) == 40 and float(c.data.brightness_delta) > 0
            and m.backbone.use_remat and m.backbone.drop_path_rate > 0 and m.embed_dim == EMBED
            and len(m.backbone.blocks) == 12 and m.cam_layer == 12 and m.num_classes == 80
            and m.num_reppoints_head == 1 and m.num_semantic_points == 3):
        raise AssertionError("the COCO CLI phase runs the config as it is")
    log(f"[coco-cli] launches per micro-step {nonzero(calls[0]['launches'])} (all "
        f"{COCO_CLI_STEPS} equal); the invocation's {nonzero(total)}")
    filled = sorted(int(v) for cl in calls for v in cl["args"][1]["gt_valid"].sum(1))
    if max(filled) != 40 or sum(v > 20 for v in filled) < 2:
        raise AssertionError(f"annotated instances per image {filled}: G = 40 never filled")
    vals = stats["metrics"]
    if set(vals) != LOSS_KEYS | RP_KEYS | {"loss_total"} or not all(map(math.isfinite, vals.values())):
        raise AssertionError(f"COCO CLI metrics {vals}")
    check_parts("coco-cli", parts, vals)
    val = stats["val"]
    if len(val) != 1 or sorted(val[0]) != COCO_VAL_KEYS or not all(map(math.isfinite, val[0].values())):
        raise AssertionError(f"COCO CLI val metrics {val}")
    subs = SUBMODULES + ("reppoints_head_0",)
    dead = [s for s in subs if not grads.get(s, 0.0) > 0]
    ckpt = torch.load(os.path.join(work, "epoch_1"), map_location="cpu", weights_only=True)
    moved = {s: 0 for s in subs}
    for k, v in ckpt["params"].items():
        if not bool(torch.isfinite(v.float()).all()):
            raise AssertionError(f"COCO epoch_1: {k} is not finite")
        moved[k.split(".", 1)[0]] += int(not torch.equal(v, init[k]))
    if dead or not all(moved.values()):
        raise AssertionError(f"COCO CLI: no gradient in {dead}; tensors moved {moved}")
    log(f"[coco-cli] instances per image {filled}; last metrics "
        f"{({k: round(v, 4) for k, v in sorted(vals.items())})}; val {val[0]}; tensors moved per "
        f"submodule {moved}")
    shapes = check_kernels_on("coco-input", handed)
    if shapes["ccl_planes"][0] != 12 * 40 or shapes["meanshift"]["G"] != 40:
        raise AssertionError(f"COCO path kernel shapes {shapes}")
    log_step_times("COCO train CLI", stats, peak, smi)
    log(f"[time] COCO eval {stats['eval_s'][0] / TRAIN_CLI_VAL:.3f} s per val image; checkpoint "
        f"save {stats['save_s'][0]:.3f} s")
    _, batch, epoch = calls[-1]["args"]
    profile_slice(lambda: cli.train_step(run, batch, epoch), statistics.median(stats["step_ms"][1:]),
                  what="COCO train CLI micro-step (batch 2)")
    del run
    return dict(total=total, node=node, tmp=tmp, opts=opts)


def phase_variant_cli(tc: dict, smi: str) -> dict:
    """``configs/attnshift_voc12aug_ts.py`` and
    ``configs/attnshift_voc12aug_keypoint.py``, each as it is, through
    ``tools.train`` on the train CLI phase's VOC tree: 2 micro-steps each,
    no evaluation. The teacher's ``backbone_forward`` counted on its own
    (forward kernels only) and the student's step beside it; one teacher
    tensor after each step against m * teacher + (1 - m) * student,
    recomputed on the host in f32. Keypoint: ``loss_keypoint_align``
    finite, a gradient in ``keypoint_align_head``."""
    import math
    from unittest import mock

    import torch

    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.tools import train as cli
    from attentionshift_torch.train import ema

    out = {}
    opts = [o for o in tc["opts"] if not o.startswith("schedule.total_epochs")]
    # the teacher's forward, counted apart from the step around it
    teacher_calls = []
    name = "mil_head.fc1.weight"
    ema_seen = []
    inner_ema = ema.ema_update

    def checked_ema(teacher, student, momentum):
        t = teacher.state_dict()[name].detach().float().cpu().clone()
        res = inner_ema(teacher, student, momentum)
        s = student.state_dict()[name].detach().float().cpu()
        want = t * momentum + s * (1.0 - momentum)
        ema_seen.append(max_err(res.state_dict()[name].cpu(), want) /
                        float(torch.finfo(torch.float32).eps * want.abs().max()))
        return res

    ts_cfg = os.path.join(HERE, "configs", "attnshift_voc12aug_ts.py")
    argv = [ts_cfg, "--work-dir", os.path.join(tc["tmp"], "work_ts"), "--max-steps",
            str(VARIANT_CLI_STEPS), "--no-validate"] + opts
    per_step = {k: TS_STUDENT_LAUNCHES.get(k, 0) + TEACHER_LAUNCHES.get(k, 0)
                for k in set(TS_STUDENT_LAUNCHES) | set(TEACHER_LAUNCHES)}
    stats, (run, _), calls, total, grads, peak = run_train_cli(
        argv, per_step, VARIANT_CLI_STEPS,
        patches=(counting(AttnShiftDetector, "backbone_forward", teacher_calls),
                 mock.patch.object(ema, "ema_update", checked_ema)))
    m = float(run.cfg.teacher.momentum)
    if not (run.cfg.teacher.enabled and m == 0.999 and run.teacher is not None
            and int(run.cfg.data.batch_size) == 2 and run.model.embed_dim == EMBED):
        raise AssertionError("the teacher phase runs configs/attnshift_voc12aug_ts.py as it is")
    want_teacher = {k: TEACHER_LAUNCHES.get(k, 0) for k in launch_counts()}
    if len(teacher_calls) != VARIANT_CLI_STEPS or any(
            cl["launches"] != want_teacher for cl in teacher_calls):
        raise AssertionError(f"teacher forward launches {[cl['launches'] for cl in teacher_calls]}")
    if len(ema_seen) != VARIANT_CLI_STEPS or max(ema_seen) > 1.0:
        raise AssertionError(f"teacher {name} vs m * t + (1 - m) * s: {ema_seen} eps of its largest")
    vals = stats["metrics"]
    if set(vals) != LOSS_KEYS | {"loss_total"} or not all(map(math.isfinite, vals.values())):
        raise AssertionError(f"teacher CLI metrics {vals}")
    log(f"[variant-cli] teacher (momentum {m}): the teacher's forward launches "
        f"{nonzero(teacher_calls[0]['launches'])} per micro-step, the whole micro-step "
        f"{nonzero(calls[0]['launches'])}; {name} after each step vs m * t + (1 - m) * s on the "
        f"host (f32): {[round(e, 3) for e in ema_seen]} eps of its largest entry; last metrics "
        f"{({k: round(v, 4) for k, v in sorted(vals.items())})}")
    log_step_times("teacher train CLI", stats, peak, smi)
    _, batch, epoch = calls[-1]["args"]
    profile_slice(lambda: cli.train_step(run, batch, epoch), stats["step_ms"][-1],
                  what="teacher train CLI micro-step (batch 2)")
    out["ts"] = total
    del run

    kp_cfg = os.path.join(HERE, "configs", "attnshift_voc12aug_keypoint.py")
    argv = [kp_cfg, "--work-dir", os.path.join(tc["tmp"], "work_kp"), "--max-steps",
            str(VARIANT_CLI_STEPS), "--no-validate"] + opts
    stats, (run, _), calls, total, grads, peak = run_train_cli(argv, TRAIN_CLI_LAUNCHES,
                                                               VARIANT_CLI_STEPS)
    if not (run.cfg.model.with_keypoint_align and hasattr(run.model, "keypoint_align_head")):
        raise AssertionError("the keypoint phase runs configs/attnshift_voc12aug_keypoint.py")
    vals = stats["metrics"]
    if (set(vals) != LOSS_KEYS | {"loss_keypoint_align", "loss_total"}
            or not all(map(math.isfinite, vals.values())) or not grads["keypoint_align_head"] > 0):
        raise AssertionError(f"keypoint CLI metrics {vals}, gradients {grads}")
    log(f"[variant-cli] keypoint align: launches per micro-step {nonzero(calls[0]['launches'])}; "
        f"loss_keypoint_align {vals['loss_keypoint_align']:.4f}, its head's largest |gradient| "
        f"{grads['keypoint_align_head']:.3e}")
    log_step_times("keypoint train CLI", stats, peak, smi)
    _, batch, epoch = calls[-1]["args"]
    profile_slice(lambda: cli.train_step(run, batch, epoch), stats["step_ms"][-1],
                  what="keypoint train CLI micro-step (batch 2)")
    out["keypoint"] = total
    del run
    return out


def phase_cascade_step(dev, smi: str) -> dict:
    """The full-width ViT-S train step at the bench geometry (800x1344,
    bf16, remat and drop path) with the combination no config sets: two
    RepPoints heads, ``with_deform_sup`` and the MAE head. Finite losses,
    the stage keys unsuffixed and suffixed ``_0``, gradients in both heads
    and the MAE decoder, the launches of the step."""
    import math

    import torch

    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step

    model = build_model(dev, torch.bfloat16, with_reppoints_head=True, num_reppoints_head=2,
                        with_deform_sup=True, with_mae_head=True)
    inp = slice_inputs(H_IMG, W_IMG, MAX_GT, N_VALID, dev)
    opt = build_optimizer(model, base_lr=1e-4, steps_per_epoch=100, accumulate_steps=1, depth=12)
    grads: dict = {}
    step_fn = make_train_step(model)
    batch = dict(zip(("img", "gt_points", "gt_labels", "gt_valid", "img_wh"), inp))
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    state = TrainState.create(model, opt)
    with gradient_tops(grads):
        reset_launches()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, generator=gen)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    want = expected_launches(**TRAIN_LAUNCHES)
    if launches != want:
        raise AssertionError(f"cascade step launches {launches} != {want}")
    vals = {k: float(v) for k, v in metrics.items()}
    keys = RP_KEYS | {k + "_0" for k in RP_KEYS} | {"loss_mae_rec"}
    if not keys <= set(vals) or not all(map(math.isfinite, vals.values())):
        raise AssertionError(f"cascade step metrics {vals}")
    heads = ("reppoints_head_0", "reppoints_head_1", "mae_head")
    if not all(grads.get(h, 0.0) > 0 for h in heads):
        raise AssertionError(f"cascade step gradients {grads}")
    log(f"[cascade] launches {nonzero(launches)}; losses "
        f"{({k: round(v, 4) for k, v in sorted(vals.items())})}; largest |gradient| "
        f"{({h: f'{grads[h]:.3e}' for h in heads})}; first step {ms:.2f} ms (host clock, "
        f"compiles nothing); peak {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; {smi}")
    t0 = time.perf_counter()
    step_fn(state, batch, generator=gen)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"[time] cascade + MAE train step (batch 1): second step {ms:.2f} ms (host clock); {smi}")
    profile_slice(lambda: step_fn(state, batch, generator=gen), ms,
                  what="cascade + MAE train step (batch 1)")
    return launches


def phase_vitb_cli(cc: dict, smi: str) -> dict:
    """``configs/attnshift_coco_vitb.py`` as it is (768 wide, 12 heads,
    layer decay 0.65) through ``tools.train`` on the COCO phase's tree, with
    a synthetic MAE ViT-B checkpoint of sharp attention (``SHARP_QKV``) as
    its ``pretrained``: one micro-step, no evaluation; the launches of that
    step, finite losses, most instances with a Stage-C part; CCL,
    mean-shift (D = 768) and the capture pair (12 heads) against their
    plain versions on the inputs this path handed them."""
    import math
    import tempfile

    import torch

    from attentionshift_torch.tools import train as cli

    mae = os.path.join(cc["tmp"], "mae_pretrain_vit_base.pth")
    torch.save({"model": mae_state_dict(d=VITB_EMBED, qkv_scale=SHARP_QKV)}, mae)
    work = tempfile.mkdtemp(prefix="vitb_", dir=cc["tmp"])
    argv = [os.path.join(HERE, "configs", "attnshift_coco_vitb.py"), "--work-dir", work,
            "--max-steps", "1", "--no-validate"] + cc["opts"] + [f"pretrained={mae}"]
    handed: dict = {}
    parts: list = []
    stats, (run, _), calls, total, grads, peak = run_train_cli(
        argv, COCO_CLI_LAUNCHES, 1, patches=(kernel_inputs_of(handed), cascade_parts(parts)))
    m = run.model
    if not (m.embed_dim == VITB_EMBED and m.backbone.blocks[0].attn.num_heads == VITB_HEADS
            and float(run.cfg.optimizer.layer_decay) == 0.65 and m.num_reppoints_head == 1):
        raise AssertionError("the ViT-B phase runs configs/attnshift_coco_vitb.py as it is")
    vals = stats["metrics"]
    if not RP_KEYS <= set(vals) or not all(map(math.isfinite, vals.values())):
        raise AssertionError(f"ViT-B CLI metrics {vals}")
    check_parts("vitb-cli", parts, vals)
    shapes = check_kernels_on("vitb-input", handed)
    if shapes["meanshift"]["D"] != VITB_EMBED or shapes["attention"][1] != VITB_HEADS:
        raise AssertionError(f"ViT-B path kernel shapes {shapes}")
    log(f"[vitb-cli] launches {nonzero(total)}; metrics "
        f"{({k: round(v, 4) for k, v in sorted(vals.items())})}")
    log_step_times("ViT-B COCO train CLI", stats, peak, smi)
    _, batch, epoch = calls[-1]["args"]
    profile_slice(lambda: cli.train_step(run, batch, epoch), stats["step_ms"][-1],
                  what="ViT-B COCO train CLI micro-step (batch 2)")
    del run
    return total


# Swin's full-width path (configs/attnshift_voc12aug_swin.py's `swin` dict:
# embed 96, depths 2/2/6/2, heads 3/6/12/24, window 7, 100 point tokens, 4
# global blocks) at the smallest geometry at or above the bench's 800x1344
# that the JAX Swin runs: every stage's map divisible by the window 7, so
# the height a multiple of 4 * 8 * 7 = 224 (800x1344 fails its reshape)
SWIN_H, SWIN_W = 896, 1344
SWIN_GRID = (SWIN_H // 32, SWIN_W // 32)  # (28, 42): 1176 patches
SWIN_POINTS = 100
SWIN_T = SWIN_GRID[0] * SWIN_GRID[1] + SWIN_POINTS  # 1276 tokens in the global blocks
SWIN_CAM_STRIDE = 8  # the config's cam_stride: CCL on (112, 168) planes
SWIN_FWD_LAUNCHES = dict(attention_capture_d32=4, ccl_batch=1)
SWIN_BWD_LAUNCHES = dict(attention_bwd_dq_d32=4, attention_bwd_dkv_d32=4)
# the attention pairs at head shapes beyond the ViT's, each forward and
# backward pair against its plain version: (shape, gap, seeds)
HEAD_SHAPE_CASES = (((1, 24, SWIN_T, 32), None, (0,)),
                    ((1, HEADS, T_PAD, 32), PAD_GAP, (0,)),
                    ((1, 24, SWIN_T, 64), None, (0,)),
                    ((2, 17, 300, 64), None, (0,)),
                    ((1, 24, 190, 32), None, tuple(range(16))))


def check_attention_pair(tag: str, q, k, v, g, gap, quiet: bool = False) -> dict:
    """Both attention pairs on (q, k, v) and upstream gradient ``g`` against
    their plain versions: ``out`` of both ops within 4 bf16 ulps of the
    largest |out|, each mean entry within ``capture_mean_limit``, dq, dk,
    dv within 4 bf16 ulps of each one's largest entry, gap columns of the
    mean, dk and dv exactly 0. Controls, each of which must fail its
    check: the plain versions without the scale d^-0.5 for out and the
    gradients (a temperature 10 % off moves too little where the
    attention is flat, as it is on a randomly initialised path); the
    temperature 10 % off and the last head off for the mean. Returns the
    largest errors per kernel."""
    import torch

    from attentionshift_torch.ops import attention

    say = (lambda *a: None) if quiet else log
    ref_out, ref_mean = attention.attention_reference(q, k, v, gap)
    unscaled = (q.float() * q.shape[-1] ** 0.5).to(q.dtype)
    ctl_out = attention.attention_reference(unscaled, k, v, gap)[0]
    out, mean = attention.attention_with_capture(q, k, v, gap)
    out2 = attention.attention_no_capture(q, k, v, gap)
    sync()
    tol = bf16_ulps(ref_out, 4)
    errs = dict(capture=max_err(out, ref_out), plain=max_err(out2, ref_out))
    for name, e in errs.items():
        if e > tol:
            raise AssertionError(f"{tag}.{name}.out: max_abs_err {e} > {tol}")
    ctl = max_err(out, ctl_out)
    if not ctl > tol:
        raise AssertionError(f"{tag}: the out check cannot see the scale left out ({ctl})")
    say(f"[check] {tag}.out: capture {errs['capture']:.3e}, plain {errs['plain']:.3e} <= "
        f"{tol:.1e} (4 bf16 ulps of the largest |out|); control (no d^-0.5) {ctl:.3e}: ok")
    if quiet:
        over = mean_over(mean, ref_mean, attention.capture_mean_limit(ref_mean))
        if over > 1.0:
            raise AssertionError(f"{tag}.mean: an entry at {over}x its limit")
    else:
        expect_capture_mean(f"{tag}.mean", mean, ref_mean, (q, k, v, gap))
    errs["capture"] = max(errs["capture"], max_err(mean, ref_mean))
    if gap is not None and float(mean[:, :, gap[0]:gap[1]].float().abs().max()) != 0.0:
        raise AssertionError(f"{tag}.mean: gap columns not 0")
    del ref_out, ref_mean, ctl_out, out, mean, out2
    want = attention.attention_backward_reference(q, k, v, g, gap)
    ctl_want = attention.attention_backward_reference(unscaled, k, v, g, gap)
    for op in (attention.attention_no_capture, attention.attention_with_capture):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = op(*leaves, gap)
        got = torch.autograd.grad(o[0] if isinstance(o, tuple) else o, leaves, g)
        sync()
        for name, a, w, c in zip(("dq", "dk", "dv"), got, want, ctl_want):
            gtol, e, ce = bf16_ulps(w, 4), max_err(a, w), max_err(a, c)
            if e > gtol:
                raise AssertionError(f"{tag}.{op.__name__}.{name}: max_abs_err {e} > {gtol}")
            if not ce > gtol:
                raise AssertionError(f"{tag}.{name}: the check cannot see the scale left out")
            key = "dq" if name == "dq" else "dkv"
            errs[key] = max(errs.get(key, 0.0), e)
            if gap is not None and name != "dq" and \
                    float(a[:, :, gap[0]:gap[1]].float().abs().max()) != 0.0:
                raise AssertionError(f"{tag}.{name}: gap columns not 0")
    say(f"[check] {tag}: dq {errs['dq']:.3e}, dk/dv {errs['dkv']:.3e} within 4 bf16 ulps of "
        f"each gradient's largest entry, both ops; control (no d^-0.5) fails: ok")
    return errs


def phase_head_shape_kernels(results: dict, dev) -> None:
    """The four attention kernels at head dim 32 and above the mean pass's
    resident heads (``HEAD_SHAPE_CASES``), forward and backward pairs
    through the ops against the plain versions. The d = 32 instances'
    errors kept for the kernel table are those at Swin's (1, 24, 1276, 32)."""
    import torch

    for shape, gap, seeds in HEAD_SHAPE_CASES:
        worst: dict = {}
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(100 + seed)
            q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                          for _ in range(4))
            if gap is not None:  # the gap's rows have no consumer in the model
                g[:, :, gap[0]:gap[1]] = 0
            errs = check_attention_pair(f"heads{shape}{'' if gap is None else ' gap'} seed {seed}",
                                        q, k, v, g, gap, quiet=len(seeds) > 1)
            worst = {n: max(worst.get(n, 0.0), e) for n, e in errs.items()}
            del q, k, v, g
        log(f"[check] head shape {shape} gap {gap}, {len(seeds)} seed(s): worst errors "
            f"{ {n: float(f'{e:.3e}') for n, e in worst.items()} }: ok")
        if shape == (1, 24, SWIN_T, 32):
            for name, key in (("attention_capture_d32", "capture"), ("attention_plain_d32", "plain"),
                              ("attention_bwd_dq_d32", "dq"), ("attention_bwd_dkv_d32", "dkv")):
                results[name] = dict(max_abs_err=worst[key])


def swin_model(dev, use_kernel: bool = True):
    """The port's Swin of ``configs/attnshift_voc12aug_swin.py`` as it is
    (its ``swin`` dict, 20 classes), seeded random weights, bf16, built
    for SWIN_H x SWIN_W."""
    import torch

    from attentionshift_torch.config import Config
    from attentionshift_torch.models.swin import SwinTransformer

    cfg = Config.fromfile(os.path.join(HERE, "configs", "attnshift_voc12aug_swin.py"))
    kw = dict(cfg.swin.to_dict(), num_classes=int(cfg.model.num_classes))
    return SwinTransformer(**kw, img_size=(SWIN_H, SWIN_W), use_kernel=use_kernel,
                           dtype=torch.bfloat16, device=dev).init_weights(seed=0)


def phase_swin(dev, smi: str) -> dict:
    """Swin's full-width path on the card: one forward at SWIN_H x SWIN_W
    (4 capture launches at (1, 24, 1276, 32)), the attention rollout and
    ``candidate_boxes`` at the config's cam stride (8 of 20 point slots
    valid, drawn as the bench draws them), one backward of a scalar of
    ``outputs_class``, ``outputs_coord`` and ``last_feat``; launch counts
    asserted per part, the kernels held on the path's own q, k, v and
    upstream gradient, the whole forward against the same module with
    ``use_kernel=False`` on the card, times and peak memory."""
    import numpy as np
    import torch

    from attentionshift_torch.ops import attention
    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.pseudo.engine import candidate_boxes
    from attentionshift_torch.pseudo.rollout import attention_rollout_point_rows

    model = swin_model(dev)
    img = torch.from_numpy(np.random.RandomState(0).randn(1, SWIN_H, SWIN_W, 3)
                           .astype(np.float32)).to(dev)
    _, pts, _, valid, _ = slice_inputs(SWIN_H, SWIN_W, MAX_GT, N_VALID, dev)
    tokens = torch.arange(MAX_GT, device=dev)
    rs = np.random.RandomState(5)
    weights = {k: torch.from_numpy(rs.randn(*s).astype(np.float32)).to(dev) for k, s in (
        ("outputs_class", (1, SWIN_POINTS, 20)), ("outputs_coord", (1, SWIN_POINTS, 2)),
        ("last_feat", (1, 1 + SWIN_T - SWIN_POINTS, 768)))}

    def forward():
        out = model(img)
        roll = attention_rollout_point_rows(out["attns"], SWIN_POINTS)
        boxes, _ = candidate_boxes(roll[:, 0], tokens, pts[0], SWIN_GRID, (SWIN_H, SWIN_W),
                                   cam_stride=SWIN_CAM_STRIDE, valid=valid[0])
        return out, boxes

    def backward(out):
        sum((out[k].float() * w).sum() for k, w in weights.items()).backward()

    handed: dict = {}
    torch.cuda.reset_peak_memory_stats()
    with recording(attention, "attention_backward_dq", handed):
        reset_launches()
        sync()
        t0 = time.perf_counter()
        out, boxes = forward()
        sync()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        fwd = launch_counts()
        reset_launches()
        t0 = time.perf_counter()
        backward(out)
        sync()
        bwd_ms = (time.perf_counter() - t0) * 1e3
        bwd = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    for what, got, want in (("forward + boxes", fwd, SWIN_FWD_LAUNCHES),
                            ("backward", bwd, SWIN_BWD_LAUNCHES)):
        if got != expected_launches(**want):
            raise AssertionError(f"swin {what} launches {nonzero(got)} != {want}")
    log(f"[swin] launches: forward + boxes {nonzero(fwd)}, backward {nonzero(bwd)}")
    t = SWIN_T + 1
    shapes = dict(attns=(4, 1, t, t), last_feat=(1, t - SWIN_POINTS, 768),
                  point_tokens=(1, SWIN_POINTS, 768), outputs_class=(1, SWIN_POINTS, 20),
                  outputs_coord=(1, SWIN_POINTS, 2))
    for key, shape in shapes.items():
        assert tuple(out[key].shape) == shape, (key, tuple(out[key].shape))
        assert bool(torch.isfinite(out[key].float()).all()), f"swin {key} not finite"
    pyramid = [tuple(f.shape) for f in out["feature"]]
    assert pyramid == [(1, SWIN_H // s, SWIN_W // s, c) for s, c in ((4, 96), (8, 192),
                                                                      (16, 384), (32, 768))]
    assert float(out["attns"][:, :, 0].float().abs().max()) == 0.0  # the zero cls row
    coord = out["outputs_coord"].float()
    assert bool(((coord >= 0) & (coord <= 1)).all())
    assert tuple(boxes.shape) == (MAX_GT, 4, 4) and bool(torch.isfinite(boxes).all())
    moved = [n for n, p in model.named_parameters()
             if p.grad is not None and bool(p.grad.abs().max() > 0)]
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters() if p.grad is not None)
    for part in ("global_block0.", "global_block3.", "stage0_block0.", "stage3_block1."):
        assert any(n.startswith(part) for n in moved), f"no gradient in {part}"
    log(f"[swin] outputs ok: pyramid {pyramid}, attns {tuple(out['attns'].shape)}, boxes of the "
        f"{N_VALID} valid points {boxes[:N_VALID, -1].tolist()}, gradients in {len(moved)} of "
        f"{len(list(model.parameters()))} parameter tensors")
    # the kernels on the path's own inputs: global block 0's q, k, v and the
    # upstream gradient its backward was handed
    (q, k, v, _, g, gap), _ = handed["attention_backward_dq"]
    assert tuple(q.shape) == (1, 24, SWIN_T, 32) and gap is None
    errs = check_attention_pair("swin path inputs", q, k, v, g, gap)
    # the whole bf16 forward against the same module with use_kernel=False
    plain = swin_model(dev, use_kernel=False)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        got, ref = model(img), plain(img)
    for key, rel in (("attns", 2e-2), ("last_feat", 5e-2), ("outputs_class", 5e-2),
                     ("outputs_coord", 2e-2)):
        r = ref[key].float()
        expect(f"swin.forward.{key}", max_err(got[key], r), rel * max(float(r.abs().max()), 1e-6),
               "kernels vs plain attention in the bf16 global blocks, on the card: relative to "
               "the largest value, as phase_small_reference")
    del plain, got, ref
    log(f"[swin] {smi}: forward + rollout + boxes {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms "
        f"(host clock, first call, ending in synchronize), peak {peak:.0f} MiB")

    def run():
        o, _ = forward()
        backward(o)

    run()
    sync()
    t0 = time.perf_counter()
    run()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"[swin] {smi}: forward + boxes + backward {ms:.2f} ms (host clock, second call)")
    _, busy = profile_slice(run, ms, what="Swin forward + boxes + backward")
    launches = {n: fwd[n] + bwd[n] for n in fwd}
    return dict(launches=launches, qkv=(q, k, v), g=g, errs=errs, ms=ms, busy=busy, peak=peak)


def phase_swin_times(results: dict, sw: dict, smi: str) -> None:
    """The d = 32 instances at Swin's (1, 24, 1276, 32), on the path's own
    inputs: flash_fwd read in turns with SDPA's forward, the backward pair
    in turns with SDPA's backward (medians of 6), each kernel alone, its
    plain version and its bound, with the exp floor at the SM clock read
    under the d = 32 flash pass; then the d = 64 mean pass streamed at 24
    heads beside the resident one at 12 (T = 1276, in turns)."""
    import torch
    import torch.nn.functional as F

    from attentionshift_torch.ops import attention

    q, k, v = sw["qkv"]
    g = sw["g"]
    b, h, t, d = q.shape
    qkv_bytes = 3 * q.numel() * 2
    flops = 4.0 * b * h * t * t * d
    (plain_ms, sdpa_fwd), (plain_reads, sdpa_reads) = in_turns(
        lambda: attention.attention_no_capture(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v))
    _, lse = attention.flash_forward(q, k, v, None, with_lse=True)
    mean_ms = median_time(lambda: attention._mean(q, k, lse, None))
    _, dd = attention.attention_backward_dq(q, k, v, lse, g)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)

    def pair():
        attention.attention_backward_dq(q, k, v, lse, g)
        attention.attention_backward_dkv(q, k, v, lse, dd, g)

    (pair_ms, lib_bwd), (pair_reads, lib_reads) = in_turns(
        pair, lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    del sdpa_out, leaves
    plain_bwd = cuda_time(lambda: attention.attention_backward_reference(q, k, v, g), reps=3)
    clk, clk_max = sm_clock_under_load(lambda: attention.flash_forward(q, k, v, None, False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = EXP2_PER_CLOCK_PER_SM * sms * clk * 1e6
    exps = float(b * h * t * t)
    stat_bytes = 2 * b * h * t * 4
    times = {
        "attention_capture_d32": dict(
            ms=median_time(lambda: attention.attention_with_capture(q, k, v)),
            plain_ms=cuda_time(lambda: attention.attention_reference(q, k, v), reps=3),
            library_ms=None, bytes=qkv_bytes + q.numel() * 2 + b * t * t * 2, ops=flops,
            exps=2 * exps),
        "attention_plain_d32": dict(
            ms=plain_ms,
            plain_ms=cuda_time(lambda: attention.attention_reference(q, k, v)[0], reps=3),
            library_ms=sdpa_fwd, bytes=qkv_bytes + q.numel() * 2, ops=flops, exps=exps),
        "attention_bwd_dq_d32": dict(
            ms=median_time(lambda: attention.attention_backward_dq(q, k, v, lse, g)),
            plain_ms=plain_bwd, library_ms=lib_bwd, bytes=6 * q.numel() * 2 + stat_bytes,
            ops=6.0 * b * h * t * t * d, exps=exps),
        "attention_bwd_dkv_d32": dict(
            ms=median_time(lambda: attention.attention_backward_dkv(q, k, v, lse, dd, g)),
            plain_ms=plain_bwd, library_ms=lib_bwd, bytes=6 * q.numel() * 2 + stat_bytes,
            ops=8.0 * b * h * t * t * d, exps=exps),
    }
    log(f"[time] {smi}: Swin shape {tuple(q.shape)}; SM clock under the d = 32 flash pass "
        f"{clk:.0f} MHz (max {clk_max:.0f}), {sms} SMs")
    log(f"[time] d32 flash_fwd {plain_ms:.4f} ms = {plain_ms / sdpa_fwd:.2f}x SDPA's forward "
        f"({sdpa_fwd:.4f} ms); readings in turns: kernel {[round(x, 4) for x in plain_reads]}, "
        f"SDPA {[round(x, 4) for x in sdpa_reads]}")
    log(f"[time] d32 mean pass alone {mean_ms:.4f} ms, exp floor {exps / exp_rate * 1e3:.4f} ms")
    log(f"[time] d32 backward pair {pair_ms:.4f} ms = {pair_ms / lib_bwd:.2f}x SDPA's backward "
        f"({lib_bwd:.4f} ms); readings in turns: pair {[round(x, 4) for x in pair_reads]}, "
        f"SDPA {[round(x, 4) for x in lib_reads]}")
    for name, tm in times.items():
        t_bytes = tm["bytes"] / PEAK_BYTES * 1e3
        t_ops = tm["ops"] / PEAK_BF16 * 1e3
        floor = tm["exps"] / exp_rate * 1e3
        results[name].update(
            ms=tm["ms"], plain_ms=tm["plain_ms"], library_ms=tm["library_ms"],
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
            exp_floor_ms=floor)
        log(f"[time] {name}: kernel {tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, library "
            f"{tm['library_ms'] if tm['library_ms'] is None else round(tm['library_ms'], 4)} ms, "
            f"bound {results[name]['bound_ms']:.4f} ms ({results[name]['bound_by']}), exp floor "
            f"{floor:.4f} ms, {tm['ops'] / (tm['ms'] * 1e-3) / 1e12:.1f} TFLOP/s")
    results["attention_capture_d32"]["mean_pass_ms"] = mean_ms
    # the d = 64 mean pass: query tiles streamed at 24 heads, resident at 12
    gen = torch.Generator(device=q.device).manual_seed(7)
    mq = {hh: tuple(torch.randn((1, hh, t, 64), generator=gen, device=q.device)
                    .to(torch.bfloat16) for _ in range(2)) for hh in (24, 12)}
    lses = {hh: attention.flash_forward(mq[hh][0], mq[hh][1], mq[hh][1], None, True)[1]
            for hh in mq}
    resident = attention.forward_library().attn_mean_resident_heads(64)
    (ms24, ms12), (r24, r12) = in_turns(
        lambda: attention._mean(mq[24][0], mq[24][1], lses[24], None),
        lambda: attention._mean(mq[12][0], mq[12][1], lses[12], None))
    log(f"[time] d64 mean pass at T = {t}: 24 heads (streamed, above the {resident} resident) "
        f"{ms24:.4f} ms = {ms24 / 24 * 1e3:.2f} us per head; 12 heads (resident) {ms12:.4f} ms = "
        f"{ms12 / 12 * 1e3:.2f} us per head; readings in turns {[round(x, 4) for x in r24]}, "
        f"{[round(x, 4) for x in r12]}")
    results["attention_capture"]["mean_pass_ms_24_heads_streamed"] = ms24
    results["attention_capture"]["mean_pass_ms_12_heads_resident"] = ms12


def phase_bank(dev) -> None:
    """The memory bank and the Sinkhorn solver (plain tensor code, no
    kernel) on the card against the same calls on the CPU in f32, at the
    JAX package's test sizes: bank fields and retrieval masks exactly,
    align losses, plans and cosines to 1e-5 of their largest magnitude
    (f32 sums in another order), the Hough correspondence to 1e-3 of its
    largest |C| (its row sums come near 0)."""
    import importlib

    import numpy as np
    import torch

    from attentionshift_torch.models import memory_bank as mb

    sk = importlib.import_module("attentionshift_torch.core.sinkhorn")
    rs = np.random.RandomState(0)
    objs = [dict(cls=int(rs.randint(3)), token=rs.randn(8).astype(np.float32),
                 parts=rs.randn(3, 8).astype(np.float32), pv=rs.rand(3) > 0.3,
                 box=np.asarray([0, 0, 5 + 20 * rs.rand(), 5 + 20 * rs.rand()], np.float32),
                 enable=i != 3) for i in range(7)]
    got = {}
    for where in (dev, torch.device("cpu")):
        bank = mb.init_bank(3, 4, 3, 8, device=where)
        t = {k: {n: torch.as_tensor(o[n]).to(where) for n in ("token", "parts", "pv", "box")}
             for k, o in enumerate(objs)}
        for i, o in enumerate(objs):
            bank = mb.bank_append(bank, torch.tensor(o["cls"], device=where), t[i]["token"],
                                  t[i]["parts"], t[i]["pv"], t[i]["box"], enable=o["enable"])
        keeps = [mb.retrieve_similar(bank, o["cls"], t[i]["token"], t[i]["box"], 0.0, (0.2, 5.0))
                 for i, o in enumerate(objs)]
        losses = torch.stack([mb.align_loss(bank, o["cls"], t[i]["token"], t[i]["parts"],
                                            t[i]["pv"], t[i]["box"], 0.0, (0.2, 5.0))
                              for i, o in enumerate(objs)])
        cost = torch.from_numpy(np.random.RandomState(1).rand(5, 7).astype(np.float32)).to(where)
        fa = torch.from_numpy(np.random.RandomState(2).randn(6, 16).astype(np.float32)).to(where)
        va = torch.tensor([1, 1, 0, 1, 1, 1], dtype=torch.bool, device=where)
        f0, f1 = (torch.from_numpy(np.random.RandomState(s).randn(5, 5, 16).astype(np.float32))
                  .to(where) for s in (3, 4))
        got[where.type] = dict(bank=bank, keeps=torch.stack(keeps), losses=losses,
                               plan=sk.sinkhorn(cost, num_iter=100),
                               corr=sk.semantic_correspondence(fa, fa[:5], va, va[:5]),
                               hough=sk.hough_matching(f0, f1, 2, 3, 3))
    sync()
    c, h = got["cuda"], got["cpu"]
    for name in mb.MemoryBank._fields:
        expect(f"bank.{name}", max_err(getattr(c["bank"], name).cpu(), getattr(h["bank"], name)),
               0.0, "copies and integer logic: exact")
    expect("bank.retrieve_similar", max_err(c["keeps"].cpu(), h["keeps"]), 0.0, "masks: exact")

    def rel(name, a, b, r, why):
        expect(name, max_err(a.cpu(), b), r * max(float(b.float().abs().max()), 1e-30), why)

    rel("bank.align_loss", c["losses"], h["losses"], 1e-5, "f32, sums in another order")
    rel("sinkhorn.plan", c["plan"], h["plan"], 1e-5, "f32, 100 logsumexp rounds")
    rel("semantic_correspondence.plan", c["corr"][0], h["corr"][0], 1e-5, "f32")
    expect("semantic_correspondence.match", max_err(c["corr"][1].cpu(), h["corr"][1]), 0.0,
           "argmax of the plan: exact")
    rel("hough_matching.Cu", c["hough"][0], h["hough"][0], 1e-5, "f32 cosines")
    expect("hough_matching.C", max_err(c["hough"][1].cpu(), h["hough"][1]),
           1e-3 * max(1.0, float(h["hough"][1].abs().max())),
           "1e-3 of the largest |C|: row sums near 0 amplify f32 order noise")


# The point-token decoding path (pseudo/point2bbox.py): the main path's
# ViT-S detector, two images decoded one at a time, each the capture
# forward, the rollout and the CCL of its 100 token planes on the cam
# stride-8 grid (100 x 168 at 800 x 1344)
P2B_IMAGES = 2
P2B_POINTS = 100
P2B_CAM_STRIDE = 8
P2B_CCL_ITERS = 64
P2B_LAUNCHES = dict(attention_capture=CAM_LAYERS, attention_plain=12 - CAM_LAYERS, ccl_batch=1)
P2B_WH = ((float(W_IMG), float(H_IMG)), INFER_WH)  # the second image's true extent is smaller


def host_ms(run) -> float:
    """Host-clock ms of ``run()`` ending in a synchronize."""
    sync()
    t0 = time.perf_counter()
    run()
    sync()
    return (time.perf_counter() - t0) * 1e3


def phase_point2bbox(dev, model, smi: str) -> dict:
    """``point2bbox`` on the main path's detector (bf16, ``pad_tokens_to``
    128): per image ``_extract`` with the capture, the rollout's full
    product and the decoding of the 100 point tokens, with exactly 7 / 5 / 1
    capture / plain / CCL launches per image. The CCL kernel's input planes
    copied to the CPU: the plain CCL's sweeps show which planes converged
    (the count at the cap is reported), its labels must equal the kernel's
    on every plane, and ``bbox_from_labels_batch`` on them must give the
    card's boxes to 1e-4 px; the control, one plane with its first
    foreground pixel cleared, must give other labels. Busy time and peak
    memory. Returns the last image's tokens, rows and detections for the
    CRF and CAM phases."""
    import importlib

    import numpy as np
    import torch

    from attentionshift_torch.ops import ccl
    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.pseudo.cam import bbox_from_labels_batch
    from attentionshift_torch.pseudo.rollout import attention_rollout_point_rows

    # the module (``pseudo`` exports its function under the same name)
    p2b = importlib.import_module("attentionshift_torch.pseudo.point2bbox")
    h, w = H_IMG, W_IMG
    imgs = [torch.from_numpy(np.random.RandomState(20 + i).randn(1, h, w, 3).astype(np.float32))
            .to(dev) for i in range(P2B_IMAGES)]

    def decode(i):
        with torch.no_grad():
            out, _, patch_hw = model._extract(imgs[i], capture=True)
            rows = attention_rollout_point_rows(out["attns"], P2B_POINTS)[-1, 0]
            dets = p2b.point2bbox(out["outputs_class"][0], out["outputs_coord"][0], rows, patch_hw,
                                  torch.tensor(P2B_WH[i], device=dev), cam_stride=P2B_CAM_STRIDE,
                                  ccl_iters=P2B_CCL_ITERS)
        return out, rows, dets

    want = expected_launches(**P2B_LAUNCHES)
    total = {k: 0 for k in want}
    at_cap, planes_total, res = 0, 0, []
    torch.cuda.reset_peak_memory_stats()
    for i in range(P2B_IMAGES):
        handed: dict = {}
        with recording(p2b, "connected_components_batch", handed):
            reset_launches()
            out, rows, dets = decode(i)
            sync()
            got = launch_counts()
        if got != want:
            raise AssertionError(f"point2bbox image {i} launches {nonzero(got)} != {P2B_LAUNCHES}")
        total = {k: total[k] + got[k] for k in total}
        (planes, iters), _ = handed["connected_components_batch"]
        assert tuple(planes.shape) == (P2B_POINTS, h // P2B_CAM_STRIDE, w // P2B_CAM_STRIDE)
        assert iters == P2B_CCL_ITERS
        kernel_labels = ccl.connected_components_batch(planes, P2B_CCL_ITERS).cpu()
        cpu_planes = planes.cpu()
        labels, sweeps = ccl.connected_components(cpu_planes, P2B_CCL_ITERS, return_sweeps=True)
        at_cap += int((sweeps >= P2B_CCL_ITERS).sum())
        planes_total += len(sweeps)
        if not torch.equal(kernel_labels, labels):
            bad = int((kernel_labels != labels).flatten(1).any(1).sum())
            raise AssertionError(f"point2bbox image {i}: CCL kernel labels differ from the plain "
                                 f"version on {bad} of the path's planes")
        ctl = cpu_planes.clone()
        k = int(ctl.flatten(1).any(1).int().argmax())
        first = int(ctl[k].flatten().int().argmax())
        ctl.view(len(ctl), -1)[k, first] = False
        if torch.equal(ccl.connected_components(ctl, P2B_CCL_ITERS), kernel_labels):
            raise AssertionError("point2bbox: the label check cannot see a flipped pixel")
        wh = torch.tensor(P2B_WH[i])
        pts = out["outputs_coord"][0].float().cpu() * wh[None]
        boxes = bbox_from_labels_batch(labels, pts / P2B_CAM_STRIDE) * P2B_CAM_STRIDE
        boxes = torch.stack([boxes[:, 0].clamp(0, wh[0]), boxes[:, 1].clamp(0, wh[1]),
                             boxes[:, 2].clamp(0, wh[0]), boxes[:, 3].clamp(0, wh[1])], -1)
        expect(f"point2bbox.image{i}.boxes", max_err(dets.boxes.cpu(), boxes), 1e-4,
               "the card's boxes vs bbox_from_labels_batch on the CPU over the card's planes, px")
        sc = dets.scores.cpu()
        assert bool(((sc >= 0) & (sc <= 1)).all()) and bool(torch.isfinite(dets.boxes).all())
        assert bool(((dets.labels >= 0) & (dets.labels < 20)).all())
        assert bool((dets.boxes[:, 2] <= wh[0].to(dev)).all() & (dets.boxes[:, 3] <= wh[1].to(dev)).all())
        log(f"[point2bbox] image {i}: launches {nonzero(got)}; CCL sweeps per plane min "
            f"{int(sweeps.min())} max {int(sweeps.max())} (cap {P2B_CCL_ITERS}); {int(dets.valid.sum())}"
            f" of {P2B_POINTS} tokens over the score floor; kernel labels equal the plain CCL's on "
            f"all {len(sweeps)} planes; control (one pixel cleared) differs: ok")
        res.append((out, rows, dets))
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[point2bbox] CCL planes at the sweep cap: {at_cap} of {planes_total} (the rest converged: "
        f"a fixpoint, which the JAX package's per-plane CCL reaches too)")
    ms = [host_ms(lambda: decode(i)) for i in range(P2B_IMAGES)]
    log(f"[point2bbox] {smi}: ms per image {[round(x, 2) for x in ms]} (host clock, second call, "
        f"ending in synchronize), peak {peak:.0f} MiB")
    _, busy = profile_slice(lambda: decode(0), ms[0], top=8, what="point2bbox image")
    out, rows, dets = res[-1]
    return dict(launches=total, out=out, rows=rows,
                dets=dets, ms=ms, busy=busy, peak=peak, at_cap=at_cap, planes=planes_total)


CRF_G, CRF_ITERS, WATER_ITERS = 20, 10, 5


def phase_crf(dev, p2b: dict) -> None:
    """``mean_field_refine`` at G = 20 on the 50 x 84 patch grid (N = 4200)
    with D = 384: the unaries the first 20 point tokens' rollout CAMs of
    ``phase_point2bbox`` (min-max normalised), the features the last
    block's patch tokens; then ``water_fill`` (5 slots) on the same
    features' cosine similarity and token 0's binarised CAM. Card against
    the CPU in f32 on the same inputs: refined maps within 1e-4 (control:
    the pairwise weight 10 % off); water-fill slots and validity equal, or
    each of the card's picks within f32 rounding of that step's best
    coverage on the CPU (control: the least-covering feature in slot 0)."""
    import torch

    from attentionshift_torch.pseudo.cam import norm_attns
    from attentionshift_torch.pseudo.crf import mean_field_refine, water_fill

    hp, wp = H_IMG // 16, W_IMG // 16
    out, rows = p2b["out"], p2b["rows"]
    cams = norm_attns(rows[:CRF_G, 1:1 + hp * wp].float().reshape(CRF_G, hp, wp))
    feats = out["last_feat"][0, 1:].float()
    got = mean_field_refine(cams, feats, num_iter=CRF_ITERS)
    want = mean_field_refine(cams.cpu(), feats.cpu(), num_iter=CRF_ITERS)
    ctl = mean_field_refine(cams.cpu(), feats.cpu(), num_iter=CRF_ITERS, pairwise_weight=1.1)
    sync()
    expect("crf.mean_field_refine", max_err(got.cpu(), want), 1e-4,
           f"({CRF_G}, {hp}, {wp}) maps in [0, 1], f32 matmuls in another order")
    if not max_err(ctl, want) > 1e-4:
        raise AssertionError("crf: the check cannot see the pairwise weight 10 % off")
    f = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-6)
    sim = f @ f.T
    attn = (cams[0] >= 0.5).float().reshape(-1)
    prots, valid = water_fill(feats, sim, attn, n_iter=WATER_ITERS)
    fc, sc, ac = feats.cpu(), sim.cpu(), attn.cpu()
    cprots, cvalid = water_fill(fc, sc, ac, n_iter=WATER_ITERS)
    sync()
    # each slot's feature row, as an index into the features
    idx = [int((fc == p).all(1).int().argmax()) for p in prots.cpu()]
    same = torch.equal(prots.cpu(), cprots) and torch.equal(valid.cpu(), cvalid)

    def witnessed(order) -> bool:
        """Replay the water fill on the CPU with the given picks: each must
        be within f32 rounding of that step's best coverage."""
        s = torch.where(sc < sc.amax(1, keepdim=True) * 0.8, 0.0, sc)
        a = ac.clone()
        for j in order:
            cov = s @ a
            tol = 4 * 2.0**-23 * float((s.abs() @ a.abs()).max())
            if float(cov.max() - cov[j]) > tol:
                return False
            a = (a - (s[j] > 0).float() * (a > 0)).clamp(0.0, 1.0)
        return True

    if not same and not (witnessed(idx) and torch.equal(valid.cpu(), cvalid)):
        raise AssertionError(f"water_fill: card slots {idx} are not the CPU's and not within "
                             f"rounding of its coverage")
    s0 = torch.where(sc < sc.amax(1, keepdim=True) * 0.8, 0.0, sc) @ ac
    if witnessed([int(s0.argmin())] + idx[1:]):
        raise AssertionError("water_fill: the witness check cannot see the least-covering pick")
    log(f"[check] crf.water_fill: {WATER_ITERS} slots {idx}, valid {valid.tolist()}: "
        f"{'equal to the CPU' if same else 'within rounding of the CPU coverage'}; control "
        f"(the least-covering feature in slot 0) fails: ok")


GEN_K = 9  # reppoints_num_points of configs/attnshift_coco.py
GEN_OBJECTS, GEN_PARTS = 40, 3 + 1  # max_gt 40; num_semantic_points 3 + the point
GEN_RASTER = 4
DEFORM_CHANNELS, DEFORM_HEADS, DEFORM_BATCH = 256, 4, 2


def gen_inputs(seed: int = 0):
    """The generator's CPU inputs at the COCO config's shapes on the
    stride-16 field of an 800 x 1344 image: a (2K, 50, 84) contour-offset
    field (N(0, 1.5) strides), 40 objects of 3 parts and a point each
    scattered around random centres, 5 % of the slots invalid."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    hf, wf = H_IMG // 16, W_IMG // 16
    field = (rs.randn(2 * GEN_K, hf, wf) * 1.5).astype(np.float32)
    centers = rs.rand(GEN_OBJECTS, 2) * [W_IMG * 0.9, H_IMG * 0.9] + [W_IMG * 0.05, H_IMG * 0.05]
    parts = centers[:, None] + rs.randn(GEN_OBJECTS, GEN_PARTS, 2) * 30
    parts = np.clip(parts, 0, [W_IMG - 1, H_IMG - 1]).reshape(-1, 2).astype(np.float32)
    obj = np.repeat(np.arange(GEN_OBJECTS), GEN_PARTS).astype(np.int64)
    valid = rs.rand(len(obj)) > 0.05
    return tuple(torch.from_numpy(a) for a in (field, parts, obj, valid))


def hull_edge_distance(verts, eps, pix, stride: float):
    """|half-plane value| of pixel centres ``pix`` (n, 2) ints (r, c) against
    the nearest edge of the closed walks ``verts`` (n, K + 1, 2), over eps."""
    import torch

    p = (pix.float() + 0.5) * stride
    p = torch.stack([p[:, 1], p[:, 0]], -1)[:, None]
    a, b = verts[:, :-1], verts[:, 1:]
    cr = (b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1]) - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0])
    return (cr.abs() / eps[:, None]).amin(1)


def phase_point_generator(dev) -> None:
    """``SupervisionPointGenerator`` at the COCO config's shapes (K = 9
    contour points, 40 objects x (3 parts + the point) = 160 parts, the
    stride-16 field of 800 x 1344, raster stride 4: (160, 200, 336) hulls),
    card against CPU on the same inputs: contour points within 1e-4 px;
    hull pixels equal, or each differing pixel on a hull edge (its
    half-plane value within 4 eps of 0; the count is reported); core
    regions, scores and keep flags equal where the hulls are. The control:
    one part's contour shifted by a raster stride must change its hull.
    Then ``DeformableConvAttention`` (256 channels, 4 heads) on a
    (2, 50, 84, 256) map, forward and backward, card against CPU: the
    output, the input gradient and every parameter gradient within 1e-4 of
    each one's largest entry (control: the temperature 10 % off)."""
    import torch

    from attentionshift_torch.models import point_generator as pg
    from attentionshift_torch.models.deformable_attention import DeformableConvAttention

    gen = pg.SupervisionPointGenerator(point_strides=16, raster_stride=GEN_RASTER)
    cpu = gen_inputs()
    hs, ws = H_IMG // GEN_RASTER, W_IMG // GEN_RASTER
    got = gen(*(t.to(dev) for t in cpu), GEN_OBJECTS)
    want = gen(*cpu, GEN_OBJECTS)
    sync()
    expect("generator.pred_points", max_err(got.pred_points.cpu(), want.pred_points), 1e-4,
           "bilinear samples x 16 + anchors, px")
    # the hulls the generator rasterised on each device
    hulls = pg.convex_hull_mask(got.pred_points, (hs, ws), float(GEN_RASTER)).cpu()
    chulls = pg.convex_hull_mask(want.pred_points, (hs, ws), float(GEN_RASTER))
    assert tuple(chulls.shape) == (GEN_OBJECTS * GEN_PARTS, hs, ws)
    diff = (hulls != chulls).nonzero()
    if len(diff):
        verts, eps = pg.hull_vertices(want.pred_points)
        dist = hull_edge_distance(verts[diff[:, 0]], eps[diff[:, 0]], diff[:, 1:], GEN_RASTER)
        if float(dist.max()) > 4.0:
            raise AssertionError(f"generator: {len(diff)} hull pixels differ, one "
                                 f"{float(dist.max()):.1f} eps off every edge")
        # a flipped pixel moves a part's coverage by at most its count over the core
        bound = len(diff) / float(want.core_regions.flatten(1).sum(1).clamp_min(1).min())
        expect("generator.scores", max_err(got.scores.cpu(), want.scores), bound,
               "hulls differ on edge pixels: their count over the smallest core")
    else:
        for name in ("core_regions", "keep"):
            if not torch.equal(getattr(got, name).cpu(), getattr(want, name)):
                raise AssertionError(f"generator: equal hulls but {name} differs")
        expect("generator.scores", max_err(got.scores.cpu(), want.scores), 1e-6,
               "ratios of integer counts")
    moved = want.pred_points.clone()
    moved[0] += GEN_RASTER
    if torch.equal(pg.convex_hull_mask(moved[:1], (hs, ws), float(GEN_RASTER)), chulls[:1]):
        raise AssertionError("generator: the hull check cannot see a contour moved by a stride")
    log(f"[check] generator: ({GEN_OBJECTS * GEN_PARTS}, {hs}, {ws}) hulls, {len(diff)} pixels "
        f"differ from the CPU's (each on a hull edge); {int(got.keep.sum())} parts kept, "
        f"{int(got.core_regions.flatten(1).any(1).sum())} of {GEN_OBJECTS} objects with a core; "
        f"control (a contour moved by {GEN_RASTER} px) differs: ok")

    hf, wf = H_IMG // 16, W_IMG // 16
    m = DeformableConvAttention(DEFORM_CHANNELS, DEFORM_HEADS, device=dev).init_weights(seed=0)
    mc = DeformableConvAttention(DEFORM_CHANNELS, DEFORM_HEADS, device="cpu")
    mc.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    g = torch.Generator().manual_seed(3)
    x = torch.randn((DEFORM_BATCH, hf, wf, DEFORM_CHANNELS), generator=g)
    wt = torch.randn(x.shape, generator=g)
    res = {}
    for name, mod, where in (("card", m, dev), ("cpu", mc, "cpu")):
        xx = x.to(where).requires_grad_(True)
        y = mod(xx)
        (y * wt.to(where)).sum().backward()
        res[name] = dict(y=y.detach().cpu(), dx=xx.grad.cpu(),
                         **{n: p.grad.cpu() for n, p in mod.named_parameters()})
    sync()
    ratios = {key: max_err(res["card"][key], ref) / (1e-4 * max(float(ref.abs().max()), 1e-30))
              for key, ref in res["cpu"].items()}
    worst = max(ratios, key=ratios.get)
    if ratios[worst] > 1.0:
        raise AssertionError(f"deformable attention {worst}: {ratios[worst]:.2f}x its limit")
    log(f"[check] deformable_attention: output, input gradient and {len(ratios) - 2} parameter "
        f"gradients within 1e-4 of each one's largest entry, card vs CPU in f32 (worst "
        f"{worst} at {ratios[worst]:.3f} of its limit): ok")
    mc.tau = 1.1
    with torch.no_grad():
        ctl = mc(x)
    if not max_err(ctl, res["cpu"]["y"]) > 1e-4 * float(res["cpu"]["y"].abs().max()):
        raise AssertionError("deformable attention: the check cannot see tau 10 % off")
    log("[check] deformable attention control (tau 10 % off) fails the output check: ok")


# the MAE encoder (models/mae_encoder.py) as ViT-B: 768 wide, 12 blocks of 12
# heads, LayerScale 0.1, split attention every 4th block global at window 14,
# at 896 x 1344 (a 56 x 84 grid: 24 windows of 196 tokens, 4704 global)
MAE_H, MAE_W = 896, 1344
# the q, k, v weights as init_weights draws them: with the JAX modules'
# lecun_normal init (about 6x the former N(0, 0.02) at these widths) the
# attention is not flat, and the checks' controls (no attention branch, no
# mask) fail without the 3x sharpening the former init needed
MAE_KW = dict(embed_dim=768, depth=12, num_heads=12, out_indices=(3, 5, 7, 11), with_fpn=True,
              init_values=0.1, split_attn_freq=4, window=14)
MAE_FWD_LAUNCHES = dict(attention_plain=12)
MAE_BWD_LAUNCHES = dict(attention_bwd_dq=12, attention_bwd_dkv=12)


def backbone_pass(model, img, wts, mask=None):
    """Forward, then the backward of a weighted sum of the outputs: the
    launches of each, the outputs and the input gradient."""
    import torch

    from attentionshift_torch.ops._build import reset_launches

    x = img.clone().requires_grad_(True)
    reset_launches()
    outs = model(x) if mask is None else model(x, mask)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sync()
    fwd = launch_counts()
    reset_launches()
    sum((o.float() * wt).sum() for o, wt in zip(outs, wts)).backward()
    sync()
    bwd = launch_counts()
    return fwd, bwd, [o.detach() for o in outs], x.grad


def rel_norm(a, ref) -> float:
    return float((a.float() - ref.float()).norm() / ref.float().norm().clamp_min(1e-30))


def check_against_plain(tag: str, got, plain, plain32, ctl, rel: float = 5e-2) -> None:
    """(outputs, input gradient) of the kernel path ``got`` against the same
    module with ``use_kernel=False``: each output within ``rel`` of the
    largest value of the bf16 plain module's (``plain``), as the Swin phase
    holds its forward; the input gradient no further from the f32 plain
    module's (``plain32``, relative norm) than 1.5x the bf16 plain
    module's own distance to it (the gradient of a bf16 network moves by
    several % with the rounding of any step, so the bf16 plain path is the
    witness of what rounding alone gives). ``ctl``, the results of a
    changed bf16 plain module, must fail both checks."""
    def outputs_ok(outs):
        return [max_err(a, r) <= rel * max(float(r.float().abs().max()), 1e-6)
                for a, r in zip(outs, plain[0])]

    ok = outputs_ok(got[0])
    errs = [round(max_err(a, r) / max(float(r.float().abs().max()), 1e-6), 5)
            for a, r in zip(got[0], plain[0])]
    if not all(ok):
        raise AssertionError(f"{tag}: outputs off the plain module's by {errs} of the largest "
                             f"value, limit {rel}")
    noise = rel_norm(plain[1], plain32[1])
    dist = rel_norm(got[1], plain32[1])
    if dist > 1.5 * noise:
        raise AssertionError(f"{tag}: input gradient {dist:.4f} from the f32 plain module's, the "
                             f"bf16 plain module {noise:.4f}")
    cdist = rel_norm(ctl[1], plain32[1])
    if all(outputs_ok(ctl[0])) or cdist <= 1.5 * noise:
        raise AssertionError(f"{tag}: the control passes a check")
    log(f"[check] {tag}: outputs within {max(errs)} of the largest value of the bf16 plain "
        f"module's (limit {rel}); input gradient {dist:.4f} from the f32 plain module's (relative "
        f"norm), the bf16 plain module's own {noise:.4f} (limit 1.5x); control fails both "
        f"(gradient {cdist:.4f}): ok")


def phase_mae_encoder(dev, smi: str) -> dict:
    """``MAEVisionTransformer`` ViT-B (``MAE_KW``) at 896 x 1344, bf16,
    batch 1: forward (exactly 12 ``flash_fwd``: 9 windowed blocks at (24,
    12, 196, 64), 3 global at (1, 12, 4704, 64)) and the backward of a
    weighted sum of the pyramid (exactly 12 + 12); the pyramid's shapes,
    finite; both attention pairs on a windowed and a global block's own q,
    k, v (``check_attention_pair``, a seeded upstream gradient); pyramid
    and input gradient against the same module with ``use_kernel=False``
    on the card (``check_against_plain``; control: the plain module
    without its attention branches, LayerScale gamma_1 = 0); host time,
    busy time and peak memory. The weights are ``init_weights(0)``'s."""
    import numpy as np
    import torch

    from unittest import mock

    from attentionshift_torch.models import layers
    from attentionshift_torch.models.mae_encoder import MAEVisionTransformer

    model = MAEVisionTransformer(**MAE_KW, dtype=torch.bfloat16, device=dev).init_weights(seed=0)
    img = torch.from_numpy(np.random.RandomState(30).randn(1, MAE_H, MAE_W, 3)
                           .astype(np.float32)).to(dev)
    d = MAE_KW["embed_dim"]
    shapes = [(1, MAE_H // s, MAE_W // s, d) for s in (4, 8, 16, 32)]
    g = torch.Generator(device=dev).manual_seed(31)
    wts = [torch.randn(s, generator=g, device=dev) / np.sqrt(np.prod(s)) for s in shapes]
    hp, wp, win = MAE_H // 16, MAE_W // 16, MAE_KW["window"]
    windows = model.block_windows(hp, wp)
    assert windows.count(0) == 3 and windows.count(win) == 9, windows
    handed: list = []
    real = layers.attention_no_capture

    def keep(q, k, v, pad_interval=None):
        handed.append((q.detach().clone(), k.detach().clone(), v.detach().clone()))
        return real(q, k, v, pad_interval)

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(layers, "attention_no_capture", keep):
        fwd, bwd, outs, dimg = backbone_pass(model, img, wts)
    peak = torch.cuda.max_memory_allocated() / 2**20
    for what, got, want in (("forward", fwd, MAE_FWD_LAUNCHES), ("backward", bwd, MAE_BWD_LAUNCHES)):
        if got != expected_launches(**want):
            raise AssertionError(f"MAE encoder {what} launches {nonzero(got)} != {want}")
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)
    assert bool(torch.isfinite(dimg).all()) and float(dimg.abs().max()) > 0
    heads, hd = MAE_KW["num_heads"], d // MAE_KW["num_heads"]
    seen = sorted({tuple(q.shape) for q, _, _ in handed})
    log(f"[mae] launches: forward {nonzero(fwd)}, backward {nonzero(bwd)}; attention shapes "
        f"{seen}; pyramid {[tuple(o.shape) for o in outs]}")
    assert seen == sorted([(1, heads, hp * wp, hd), (hp * wp // win**2, heads, win**2, hd)]), seen
    # the kernels on a windowed and a global block's own q, k, v (a seeded
    # upstream gradient)
    for shape in seen:
        q, k, v = next(a for a in handed if tuple(a[0].shape) == shape)
        gg = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        check_attention_pair(f"mae path inputs {shape}", q, k, v, gg, None)
    del handed
    runs = {}
    for name, dtype in (("plain", torch.bfloat16), ("plain32", torch.float32), ("ctl", torch.bfloat16)):
        plain = MAEVisionTransformer(**MAE_KW, use_kernel=False, dtype=dtype, device=dev)
        plain.load_state_dict(model.state_dict())
        if name == "ctl":  # without its attention branches
            with torch.no_grad():
                for blk in plain.blocks:
                    blk.gamma_1.zero_()
        runs[name] = backbone_pass(plain, img, wts)[2:]
        del plain
    check_against_plain("mae", (outs, dimg), runs["plain"], runs["plain32"], runs["ctl"])
    del runs
    ms = host_ms(lambda: backbone_pass(model, img, wts))
    log(f"[mae] {smi}: forward + backward {ms:.2f} ms (host clock, second call), peak {peak:.0f} MiB")
    _, busy = profile_slice(lambda: backbone_pass(model, img, wts), ms, top=8,
                            what="MAE ViT-B forward + backward")
    return dict(launches={k: fwd[k] + bwd[k] for k in fwd}, ms=ms, busy=busy, peak=peak)


MIM_BATCH, MIM_MASK_RATIO = 8, 0.4
MIM_FWD_LAUNCHES = dict(attention_plain=12)
MIM_BWD_LAUNCHES = dict(attention_bwd_dq=12, attention_bwd_dkv=12)


def phase_mim(dev, smi: str) -> dict:
    """``MIMViT`` ViT-S at 224 (bf16, batch 8, 40 % of the patches masked)
    feeding ``IBOTHead(out_dim=8192, patch_out_dim=8192)`` and
    ``DINOHead(out_dim=65536)`` (hidden 2048, bottleneck 256, f32): forward
    (exactly 12 ``flash_fwd`` at (8, 6, 197, 64)) and the backward of a
    weighted sum of the outputs (exactly 12 + 12); the tokens and the image
    gradient against the same ViT with ``use_kernel=False`` on the card
    (``check_against_plain``; control: no mask; ``init_weights``' q, k, v,
    as in the MAE phase); the heads on the card
    against the CPU in f32 on the card's tokens (1e-4 of the largest
    logit; control: the tokens of another image). Host time, busy time,
    peak memory."""
    import numpy as np
    import torch

    from attentionshift_torch.models.ssl import DINOHead, IBOTHead, MIMViT

    vit = MIMViT(dtype=torch.bfloat16, device=dev).init_weights(seed=0)
    ibot = IBOTHead(384, out_dim=8192, patch_out_dim=8192, device=dev).init_weights(seed=1)
    dino = DINOHead(384, out_dim=65536, device=dev).init_weights(seed=2)

    def run(x, m):
        """The tokens and the three logit tensors."""
        tokens = vit(x, m)
        return (tokens, *ibot(tokens), dino(tokens[:, 0]))

    g = torch.Generator(device=dev).manual_seed(40)
    img = torch.randn((MIM_BATCH, 224, 224, 3), generator=g, device=dev)
    mask = torch.rand((MIM_BATCH, 196), generator=g, device=dev) < MIM_MASK_RATIO
    shapes = [(MIM_BATCH, 197, 384), (MIM_BATCH, 8192), (MIM_BATCH, 196, 8192), (MIM_BATCH, 65536)]
    wts = [torch.randn(s, generator=g, device=dev) / np.sqrt(np.prod(s)) for s in shapes]
    torch.cuda.reset_peak_memory_stats()
    fwd, bwd, outs, dimg = backbone_pass(run, img, wts, mask)
    peak = torch.cuda.max_memory_allocated() / 2**20
    for what, got, want in (("forward", fwd, MIM_FWD_LAUNCHES), ("backward", bwd, MIM_BWD_LAUNCHES)):
        if got != expected_launches(**want):
            raise AssertionError(f"MIM {what} launches {nonzero(got)} != {want}")
    assert [tuple(o.shape) for o in outs] == shapes
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs) and float(dimg.abs().max()) > 0
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for p in (vit.mask_token, ibot.last_layer2.weight_v, dino.last_layer.weight_v))
    log(f"[mim] launches: forward {nonzero(fwd)}, backward {nonzero(bwd)}; outputs "
        f"{[tuple(o.shape) for o in outs]}; gradients in the mask token and both heads")
    tw = wts[:1]
    kernel = backbone_pass(vit, img, tw, mask)[2:]
    runs = {}
    for name, dtype in (("plain", torch.bfloat16), ("plain32", torch.float32), ("ctl", torch.bfloat16)):
        plain = MIMViT(use_kernel=False, dtype=dtype, device=dev)
        plain.load_state_dict(vit.state_dict())
        runs[name] = backbone_pass(plain, img, tw, None if name == "ctl" else mask)[2:]
        del plain
    check_against_plain("mim.tokens", kernel, runs["plain"], runs["plain32"], runs["ctl"])
    del runs, kernel
    tokens = outs[0].float()
    heads_cpu = IBOTHead(384, out_dim=8192, patch_out_dim=8192, device="cpu")
    heads_cpu.load_state_dict({k: v.cpu() for k, v in ibot.state_dict().items()})
    dino_cpu = DINOHead(384, out_dim=65536, device="cpu")
    dino_cpu.load_state_dict({k: v.cpu() for k, v in dino.state_dict().items()})
    with torch.no_grad():
        want = [*heads_cpu(tokens.cpu()), dino_cpu(tokens[:, 0].cpu())]
        ctl = [*heads_cpu(tokens.cpu().roll(1, 0)), dino_cpu(tokens[:, 0].cpu().roll(1, 0))]
    for name, a, r, c in zip(("ibot.cls", "ibot.patch", "dino"), outs[1:], want, ctl):
        tol = 1e-4 * float(r.abs().max())
        expect(f"mim.{name}", max_err(a.cpu(), r), tol, "f32 heads, card vs CPU, relative")
        if not max_err(c, r) > tol:
            raise AssertionError(f"mim.{name}: the check cannot see another image's tokens")
    ms = host_ms(lambda: backbone_pass(run, img, wts, mask))
    log(f"[mim] {smi}: forward + backward {ms:.2f} ms (host clock, second call), peak "
        f"{peak:.0f} MiB")
    _, busy = profile_slice(lambda: backbone_pass(run, img, wts, mask), ms,
                            top=8, what="MIM ViT-S + heads forward + backward")
    return dict(launches={k: fwd[k] + bwd[k] for k in fwd}, ms=ms, busy=busy, peak=peak)


def cam_weights(model, out, roi_map, wh, fb, fl):
    """grad-CAM's per-channel weights (the spatial mean of the match
    score's gradient in ``roi_map``) of image 0, f32."""
    import torch

    from attentionshift_torch.utils.det_cam import det_box_score

    rm = roi_map.detach().requires_grad_(True)
    with torch.enable_grad():
        t = model.test_from_feats(out, rm, wh, (H_IMG, W_IMG))
        score = det_box_score(t.dets.boxes[0], t.dets.scores[0], t.dets.labels[0],
                              t.dets.valid[0], fb, fl)
        (g,) = torch.autograd.grad(score, rm)
    return g[0].float().mean(dim=(1, 2))


def phase_det_cam(dev, model, smi: str) -> None:
    """``grad_cam`` on the main path's detector at 800 x 1344 (its backbone
    bf16, its heads differentiated in f32; score floor lowered as in the
    inference phase) for its own top valid detection (none valid: the
    phase fails): (50, 84), finite, in [0, 1], its maximum 1 (or 0 where no
    channel sum is positive); against the CPU f32 ``test_from_feats``
    gradient on the card's backbone outputs copied to the CPU, within 1e-3
    after normalisation (control: the card's CAM for another focal label,
    which nothing matches). Reported beside it: how far bf16 heads would
    move the channel weights, and the map's sensitivity to them.
    ``eigen_cam`` and ``featmap_am`` on the card against the CPU: on the
    path's RoI map (EigenCAM checked when sigma_1 / sigma_2 > 2, else its
    gap reported) and on a rank-one-plus-noise map; ``cam_on_image`` once."""
    import numpy as np
    import torch

    from attentionshift_torch.utils.det_cam import (cam_on_image, eigen_cam, featmap_am, grad_cam,
                                                    grad_cam_from_feats)

    img, _, _, _, wh = slice_inputs(H_IMG, W_IMG, MAX_GT, N_VALID, dev)
    floor = model.test_score_thr
    model.test_score_thr = INFER_SCORE_THR
    try:
        with torch.no_grad():
            out, roi_map, _ = model._extract(img, with_features=True, capture=False)
            dets = model.test_from_feats(out, roi_map, wh, (H_IMG, W_IMG)).dets
        valid = dets.valid[0]
        if not bool(valid.any()):
            raise AssertionError("det_cam: the detector kept no valid detection")
        k = int(valid.int().argmax())
        fb, fl = dets.boxes[0, k:k + 1].float(), dets.labels[0, k:k + 1]
        ms = host_ms(lambda: grad_cam(model, img, wh, fb, fl))
        cam = grad_cam(model, img, wh, fb, fl).cpu()
        assert tuple(cam.shape) == (H_IMG // 16, W_IMG // 16) and bool(torch.isfinite(cam).all())
        assert float(cam.min()) >= 0 and float(cam.max()) in (0.0, 1.0)
        f32 = {"feature": tuple(f.float() for f in out["feature"])}
        ctl = grad_cam_from_feats(model, f32, roi_map.float(), wh, (H_IMG, W_IMG), fb,
                                  (fl + 1) % 20).cpu()
        w32 = cam_weights(model, f32, roi_map.float(), wh, fb, fl)
        w16 = cam_weights(model, out, roi_map, wh, fb, fl)
        host = build_model("cpu", torch.float32)
        host.load_state_dict(model.state_dict())
        host.test_score_thr = INFER_SCORE_THR
        want = grad_cam_from_feats(host, {"feature": tuple(f.cpu() for f in f32["feature"])},
                                   roi_map.float().cpu(), wh.cpu(), (H_IMG, W_IMG), fb.cpu(),
                                   fl.cpu())
        del host
    finally:
        model.test_score_thr = floor
    sync()
    expect("det_cam.grad_cam", max_err(cam, want), 1e-3,
           "the card's CAM vs the CPU's f32 heads on the card's backbone outputs, normalised")
    if not max_err(ctl, want) > 1e-3:
        raise AssertionError("det_cam: the grad-CAM check cannot see another focal label")
    # how far rounding in the weights can move the map: sum_c |w_c act_c|
    # over the largest channel sum
    terms = w32[:, None, None] * roi_map[0].float()
    kappa = float(terms.abs().sum(0).max() / terms.sum(0).clamp_min(0).max().clamp_min(1e-30))
    log(f"[det_cam] {smi}: grad_cam {ms:.2f} ms (host clock, backbone + heads + backward); bf16 "
        f"heads would put the channel weights {rel_norm(w16, w32):.4f} off the f32 heads' "
        f"(relative norm) for a map whose sum_c |w_c act_c| / max is {kappa:.1f} (reported)")
    act = roi_map[0].float()
    x = act.reshape(act.shape[0], -1).T
    sv = torch.linalg.svdvals(x - x.mean(0)).cpu()
    gap = float(sv[0] / sv[1])
    expect("det_cam.featmap_am", max_err(featmap_am(act).cpu(), featmap_am(act.cpu())), 1e-5,
           "channel mean, min-max scaled")
    if gap > 2.0:
        expect("det_cam.eigen_cam(path)", max_err(eigen_cam(act).cpu(), eigen_cam(act.cpu())),
               1e-3, "first principal component, card SVD vs CPU SVD")
    log(f"[det_cam] the path's RoI map: sigma_1 / sigma_2 = {gap:.3f} "
        f"({'checked' if gap > 2.0 else 'no clear gap: EigenCAM undefined there, not compared'})")
    g = torch.Generator().manual_seed(50)
    c, hh, ww = act.shape
    r1 = (torch.randn(c, 1, 1, generator=g) * torch.rand(1, hh, ww, generator=g)
          + 0.01 * torch.randn(c, hh, ww, generator=g))
    expect("det_cam.eigen_cam(rank one)", max_err(eigen_cam(r1.to(dev)).cpu(), eigen_cam(r1)), 1e-3,
           "rank one + 1 % noise: a clear singular gap")
    pix = (np.random.RandomState(51).rand(H_IMG, W_IMG, 3) * 255).astype(np.uint8)
    over = cam_on_image(pix, cam)
    assert over.shape == pix.shape and over.dtype == np.uint8 and not np.array_equal(over, pix)
    log(f"[det_cam] cam_on_image: {over.shape} uint8 overlay, changed from the image: ok")


def phase_vis_tools(tc: dict, ev: dict) -> None:
    """The two visualisation entry points, once each:
    ``tools.browse_dataset`` on the train CLI phase's synthetic VOC point
    tree with ``configs/attnshift_voc12aug.py``'s pipeline, and
    ``tools.analysis.analyze_results`` on the eval phase's ``--dump-preds``
    pickle (single-scale, lowered score floor) and its VOC tree. Every png
    exists and is not blank."""
    import contextlib
    import io

    import numpy as np
    from PIL import Image

    from attentionshift_torch.tools import browse_dataset
    from attentionshift_torch.tools.analysis import analyze_results

    out = os.path.join(tc["tmp"], "vis")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        browsed = browse_dataset.main([tc["cfg"], "--num", "4", "--out-dir", out + "/browse",
                                       "--cfg-options", *tc["opts"][1:3]])
        ranked = analyze_results.main([ev["dump"], "--dataset-split", ev["split"], "--voc-root",
                                       ev["root"], "--out", out + "/analyze", "-k", "1"])
    for paths, n in ((browsed, 4), (ranked, 2)):
        if len(paths) != n:
            raise AssertionError(f"vis tools wrote {paths}")
        for p in paths:
            a = np.asarray(Image.open(p))
            if a.ndim != 3 or float(a.std()) == 0.0:
                raise AssertionError(f"{p}: blank")
    log(f"[vis-tools] browse_dataset wrote {len(browsed)} pngs, analyze_results {len(ranked)} "
        f"({[os.path.basename(p) for p in ranked]}), none blank: ok")


# the learning tools' run in phase_learning: learning_check's arguments
# cover every branch (the detection chain, the dagger loop)
LEARN_STEPS, LEARN_TRAIN, LEARN_EVAL, LEARN_DAGGER = 20, 16, 8, 10
LEARN_ARGV = ["--corpus", "lobes", "--train-images", str(LEARN_TRAIN), "--eval-images",
              str(LEARN_EVAL), "--steps", str(LEARN_STEPS), "--milestones", "0", str(LEARN_STEPS),
              "--det-eval", "--dagger", str(LEARN_DAGGER)]
LEARN_ROW_KEYS = ["step", "loss", "pseudo_box_iou", "pseudo_mask_iou", "mAP25", "mAP50", "mAP75",
                  "n_det"]
LEARN_T = 1 + 32 * 32 + 100  # tokens at 512x512: cls, patches, point tokens; no pad gap
LEARN_PLANES = (CAM_LAYERS * 8, 32, 32)  # CCL: captured layers x max_gt 8 on the token grid


def timed_train_steps(steps: list):
    """Patch ``train.make_train_step`` so that each step of the functions it
    builds appends (its launches, host-clock ms ending in a synchronize, the
    step function, its state and batch) to ``steps``."""
    from unittest import mock

    import attentionshift_torch.train as train_pkg

    inner = train_pkg.make_train_step

    def make(model, group=None):
        fn = inner(model, group)

        def step(state, batch, **kw):
            before = launch_counts()
            t0 = time.perf_counter()
            out = fn(state, batch, **kw)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
            steps.append(({k: after[k] - before[k] for k in after}, ms, fn, state, batch))
            return out

        return step

    return mock.patch.object(train_pkg, "make_train_step", make)


def phase_learning(smi: str) -> dict:
    """The two learning tools at 512x512 (ViT-S flagship, bf16, ``max_gt``
    8, 512 proposals). ``tools.debug_overfit`` whole: 60 steps on its 8-disc
    corpus, its own checks (``loss_total`` and ``loss_point_cls`` over the
    last 8 steps below the first 8). ``tools.analysis.learning_check`` on
    the lobes corpus with every branch (``LEARN_ARGV``: 20 steps,
    milestones 0 and 20 with the detection chain, a 10-step dagger loop):
    the milestone rows well-formed and finite, the dagger's IoUs in [0, 1].
    Exact launch counts of both runs: per train step ``TRAIN_LAUNCHES``,
    per scored image ``SEED_LAUNCHES``, per ``simple_test`` image 12
    ``flash_fwd``, none in the Mask R-CNN. CCL, mean-shift and the capture
    pair against their plain versions on the inputs the learning check
    handed them (T = 1125 tokens, no gap; 56 planes of 32x32), and both
    pairs on the same q, k, v with a seeded upstream gradient
    (``check_attention_pair``). ms per train step (host clock, median), one
    profiled step, peak memory. Returns each run's launches."""
    import math
    import statistics

    import torch

    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.tools import debug_overfit
    from attentionshift_torch.tools.analysis import learning_check

    res = {}
    for name, run, argv, scored, tested in (
            ("debug_overfit", debug_overfit.main, [], 0, 0),
            ("learning_check", learning_check.main, LEARN_ARGV,
             2 * LEARN_EVAL + LEARN_TRAIN, 2 * LEARN_EVAL + LEARN_EVAL)):
        steps, handed = [], {}
        torch.cuda.reset_peak_memory_stats()
        with timed_train_steps(steps), kernel_inputs_of(handed):
            reset_launches()
            t0 = time.perf_counter()
            out = run(argv)
            sync()
            wall = time.perf_counter() - t0
            total = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        n = len(steps)
        want = expected_launches(**{k: n * v for k, v in TRAIN_LAUNCHES.items()})
        for k, v in SEED_LAUNCHES.items():
            want[k] += scored * v
        want["attention_plain"] += tested * SINGLE_FLASH_PER_IMAGE
        bad = [i for i, st in enumerate(steps) if st[0] != expected_launches(**TRAIN_LAUNCHES)]
        if bad or total != want:
            raise AssertionError(f"{name}: launches {nonzero(total)} != {nonzero(want)}; steps "
                                 f"off the per-step count: {bad}")
        ms = [st[1] for st in steps]
        log(f"[learning] {name}: {n} train steps in {wall:.1f} s (the whole run); launches "
            f"{nonzero(total)}; ms per step {statistics.median(ms[1:]):.2f} (host clock, median "
            f"of steps 2-{n}; first {ms[0]:.2f}); peak {peak:.0f} MiB allocated; {smi}")
        res[name] = dict(launches=total, steps=steps, ms=ms, out=out, handed=handed)
    first, last = res["debug_overfit"]["out"]["first"], res["debug_overfit"]["out"]["last"]
    log(f"[learning] debug_overfit: loss_total {first['loss_total']:.3f} -> "
        f"{last['loss_total']:.3f}, loss_point_cls {first['loss_point_cls']:.3f} -> "
        f"{last['loss_point_cls']:.3f} (means of the first and last {debug_overfit.WINDOW} of "
        f"{debug_overfit.STEPS} steps): ok")
    summary = res["learning_check"]["out"]
    rows = summary["table"]
    if [r["step"] for r in rows] != [0, LEARN_STEPS] or any(list(r) != LEARN_ROW_KEYS
                                                            for r in rows):
        raise AssertionError(f"learning_check rows {rows}")
    for r in rows:
        if not (all(0.0 <= r[k] <= 1.0 for k in LEARN_ROW_KEYS[2:7]) and 0 <= r["n_det"] <= 800):
            raise AssertionError(f"learning_check row {r}")
    dag = summary["dagger"]
    if not (math.isfinite(rows[-1]["loss"]) and math.isfinite(dag["final_loss"])
            and all(0.0 <= dag[k] <= 1.0 for k in ("flagship_det_mask_iou",
                                                  "dagger_det_mask_iou"))):
        raise AssertionError(f"learning_check: {rows[-1]}, dagger {dag}")
    log(f"[learning] learning_check rows {rows}; dagger {dag}; wall {summary['wall_s']} s "
        f"(the tool's own clock, flagship part)")
    handed = res["learning_check"]["handed"]
    shapes = check_kernels_on("learning-input", handed)
    if (shapes["attention"] != (1, HEADS, LEARN_T, HEAD_DIM) or shapes["pad"] is not None
            or shapes["ccl_planes"] != LEARN_PLANES or shapes["meanshift"]["G"] != 8):
        raise AssertionError(f"learning path kernel shapes {shapes}")
    q, k, v = (x.contiguous() for x in handed["attention_with_capture"][0][:3])
    g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(5),
                    device=q.device).bfloat16()
    check_attention_pair("learning-input.pair", q, k, v, g, None, quiet=True)
    # what set this path's inputs apart for pass A's D (ROADMAP section C):
    # keys sharing a large mean
    kf = k.float()
    mean_key = kf.mean(2, keepdim=True)
    log(f"[learning] both attention pairs on the path's own q, k, v: ok; the largest norm of a "
        f"head's mean key over the largest mean distance of a key from it: "
        f"{float(mean_key.norm(dim=-1).max() / (kf - mean_key).norm(dim=-1).mean(2).max()):.2f}")
    *_, fn, state, batch = res["learning_check"]["steps"][-1]
    gen = torch.Generator(device=q.device).manual_seed(42 + LEARN_STEPS)
    profile_slice(lambda: fn(state, batch, generator=gen),
                  statistics.median(res["learning_check"]["ms"][1:]), top=8,
                  what="learning-check train step (512x512)")
    return {name: r["launches"] for name, r in res.items()}


# the export phase: the VOC config's simple_test at the bench geometry, baked
# weights; the refinement config's Mask R-CNN at its own test scale
# (EXPORT_MRCNN_ARGS: extra export_program arguments, for a rehearsal)
EXPORT_MRCNN_ARGS: list = []
EXPORT_FLASH = 12  # flash_fwd launches of one run of the exported detector


def graph_ops(program) -> list:
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def host_ms(fn, reps: int = 3) -> float:
    """ms per call on the host clock over ``reps`` calls ending in a
    synchronise (after one call outside the clock)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_export(smi: str) -> dict:
    """The serving export (``tools/deployment/export_program.py``, the twin
    of the JAX package's StableHLO exporter): the VOC config's
    ``simple_test`` at 800 x 1344 (ViT-S, bf16, weights baked in) exported
    with ``torch.export``, saved, reloaded and held to the live model at
    rtol = atol = 1e-5 (the tool's own round trip); its graph holds the
    plain-attention custom op once per block and the NMS ``while_loop``;
    one run of the reloaded program launches ``flash_fwd`` 12 times and
    nothing else. Exported and eager ms per image (host clock, synchronised
    calls, in turns). Then the refinement config's Mask R-CNN, exported and
    round-tripped once (no kernel)."""
    import atexit
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.tools.deployment import export_program as ep

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    atexit.register(shutil.rmtree, tmp, True)
    cfg = os.path.join(HERE, "configs", "attnshift_voc12aug.py")
    path = os.path.join(tmp, "detector.pt2")
    t0 = time.perf_counter()
    res = ep.main([cfg, "--out", path, "--scale", str(H_IMG), str(W_IMG)])
    export_s = time.perf_counter() - t0
    ops = graph_ops(res["program"])
    plain = ops.count("attentionshift.attention_plain.default")
    if (plain != EXPORT_FLASH or "attentionshift.attention_capture.default" in ops
            or "while_loop" not in ops):
        raise AssertionError(f"exported graph: {plain} plain-attention ops, capture ops "
                             f"{ops.count('attentionshift.attention_capture.default')}, "
                             f"while_loop {'while_loop' in ops}")
    program = torch.export.load(path).module()
    dev = res["args"][-1].device
    img = torch.from_numpy(np.random.RandomState(1).randn(1, H_IMG, W_IMG, 3)
                           .astype(np.float32)).to(dev)
    wh = res["args"][-1]
    with torch.no_grad():
        reset_launches()
        program(img, wh)
        sync()
        launches = {name: k.launches for name, k in KERNELS.items()}
        want = expected_launches(attention_plain=EXPORT_FLASH)
        if launches != want:
            raise AssertionError(f"one run of the reloaded program launched {launches}, "
                                 f"expected {want}")
        exported_ms, eager_ms = [], []
        for r in range(4):
            pair = [(exported_ms, lambda: program(img, wh)),
                    (eager_ms, lambda: res["live"](img, wh))]
            for store, fn in (pair if r % 2 == 0 else pair[::-1]):
                store.append(host_ms(fn))
    log(f"[export] detector simple_test at {H_IMG}x{W_IMG} (ViT-S, bf16, weights baked): "
        f"exported, saved and round-tripped at 1e-5 in {export_s:.1f} s, "
        f"{res['bytes'] / 1e6:.1f} MB; graph: {plain} attention_plain ops, NMS while_loop "
        f"{ops.count('while_loop')}; one reloaded run: {EXPORT_FLASH} flash_fwd, nothing else")
    log(f"[export] ms/img (host clock over 3 synchronised calls, 4 readings in turns): exported "
        f"{[round(x, 2) for x in exported_ms]}, eager {[round(x, 2) for x in eager_ms]}; "
        f"medians {statistics.median(exported_ms):.2f} / {statistics.median(eager_ms):.2f} "
        f"({smi})")
    mr_cfg = os.path.join(HERE, "configs", "mrcnn_refine_voc.py")
    t0 = time.perf_counter()
    reset_launches()
    mr = ep.main([mr_cfg, "--out", os.path.join(tmp, "mrcnn.pt2")] + EXPORT_MRCNN_ARGS)
    sync()
    mr_s = time.perf_counter() - t0
    if any(k.launches for k in KERNELS.values()):
        raise AssertionError("the Mask R-CNN export launched a hand-written kernel")
    if "nonzero" in " ".join(graph_ops(mr["program"])):
        raise AssertionError("the exported Mask R-CNN holds a data-dependent nonzero")
    log(f"[export] Mask R-CNN ({os.path.basename(mr_cfg)}) at {mr['hw'][0]}x{mr['hw'][1]}, f32: "
        f"exported, saved and round-tripped at 1e-5 in {mr_s:.1f} s, {mr['bytes'] / 1e6:.1f} MB "
        f"({smi})")
    return launches


BENCH_HW = (608, 1024)  # the benchmark tool's default shape


def phase_user_tools(ev: dict, smi: str) -> dict:
    """The last user tools on the card: the FPS harness
    (``tools/analysis/benchmark.py``) at 608 x 1024 with its defaults, the
    FLOPs report (``get_flops.py``) of the VOC config at its default 512 x
    512 with the attention ops' count against 12 x 4 B H T^2 d, and the
    robustness benchmark (``test_robustness.py``) on the eval phase's VOC
    tree and checkpoint (one corruption, one severity). Returns the
    launches of the three."""
    import math

    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.tools.analysis import benchmark, get_flops, test_robustness

    total = dict.fromkeys(KERNELS, 0)

    def add():
        sync()
        for name, k in KERNELS.items():
            total[name] += k.launches

    reset_launches()
    rec = benchmark.main(["--height", str(BENCH_HW[0]), "--width", str(BENCH_HW[1])])
    add()
    log(f"[tools] benchmark: {rec['value']} img/s, {rec['latency_ms']} ms/img at "
        f"{BENCH_HW[0]}x{BENCH_HW[1]}, batch 1, bf16, ViT-S ({smi})")
    reset_launches()
    cfg = os.path.join(HERE, "configs", "attnshift_voc12aug.py")
    fl = get_flops.main([cfg])
    add()
    t = 1 + (512 // 16) ** 2 + 100
    want = 12 * 4 * 6 * t * t * 64
    if fl["attention_flops"] != want:
        raise AssertionError(f"get_flops: attention {fl['attention_flops']} != 12 x 4 B H T^2 d "
                             f"= {want}")
    log(f"[tools] get_flops at 512x512: {fl['flops'] / 1e9:.2f} GFLOPs, of them the attention "
        f"ops {fl['attention_flops'] / 1e9:.2f} ({fl['attention_flops'] / fl['flops']:.1%}); "
        f"parameters read {fl['params'] / 1e6:.2f} M")
    reset_launches()
    rob = test_robustness.main(ev["base"] + ["--corruptions", "contrast", "--severities", "1"])
    add()
    summary = rob["summary"]
    if set(summary) < {"P", "PC", "mPC"} or not all(
            math.isfinite(v) for v in [summary["P"], summary["mPC"], *summary["PC"].values()]):
        raise AssertionError(f"test_robustness summary {summary}")
    log(f"[tools] test_robustness on {len(EVAL_SIZES)} VOC-size images, contrast s1: {summary}")
    return total


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
    _, lse = attention.flash_forward(q, k, v, PAD_GAP, with_lse=True)
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
    _, dd = attention.attention_backward_dq(q, k, v, lse, g, PAD_GAP)
    # one plain backward computes all three gradients: its time stands beside
    # both kernels; so does the library's, the backward of SDPA with the mask,
    # read in turns with the pair
    plain_bwd = cuda_time(lambda: attention.attention_backward_reference(q, k, v, g, PAD_GAP),
                          reps=3)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)

    def pair():
        attention.attention_backward_dq(q, k, v, lse, g, PAD_GAP)
        attention.attention_backward_dkv(q, k, v, lse, dd, g, PAD_GAP)

    (pair_ms, lib_bwd), (pair_reads, lib_reads) = in_turns(
        pair, lambda: torch.autograd.grad(sdpa_out, leaves, g, retain_graph=True))
    del sdpa_out, leaves
    stat_bytes = 2 * b * h * t * 4  # the row statistic and D, f32
    times["attention_bwd_dq"] = dict(
        ms=median_time(lambda: attention.attention_backward_dq(q, k, v, lse, g, PAD_GAP)),
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
    turn_ms = phase_tool_shape_turns(inp["tool_qkv"], exp_rate)
    sdpa_no_gap = turn_ms["SDPA forward"]
    for name, (kernel, _) in attention_variants.VARIANTS.items():
        # v6's V has 72 columns: its bound reads them and multiplies them
        pv_cols = d + 8 if name == "v6-fusedsum" else d
        times[kernel] = dict(
            ms=turn_ms[name] if name in turn_ms else cuda_time(
                lambda n=name: attention_variants.attention_variant(tq, tk, tv, n)),
            plain_ms=cuda_time(lambda n=name: attention_variants.variant_reference(tq, tk, tv, n),
                               reps=3),
            library_ms=sdpa_no_gap,
            bytes=(3 * d + pv_cols) * tq.numel() // d * 2 + b * tt * tt * 2,
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


def phase_tool_shape_turns(tool_qkv, exp_rate: float) -> dict:
    """The tool's variants (v2, v3, v4, v5, v6), the shipped capture pair
    and SDPA's forward at the microbenchmark's shape (1, 6, 4301, 64), read
    in turns (medians of 6): each one's ms, its ratio to the bound of the
    capture function (products and bytes of out + mean) and to the
    two-pass exp floor (2 * B*H*T^2 exp2 at ``exp_rate``), its kernels'
    device ms per launch (profiled) and registers. Returns name -> median
    ms."""
    import torch.nn.functional as F

    from attentionshift_torch.ops import attention, attention_variants

    tq, tk, tv = tool_qkv
    b, h, t, d = tq.shape
    variants = {"v2-bf16e": ("attn_v2_bf16e", "attn_var_mean"),
                "v3-nomin": ("attn_v3_nomin", "attn_var_mean_nomin"),
                "v4-mxsum": ("attn_v4_mxsum", "attn_var_mean"),
                "v5-batched": ("attn_v5_batched",),
                "v6-fusedsum": ("attn_v6_fusedsum", "attn_var_mean")}
    turns = {n: (lambda n=n: attention_variants.attention_variant(tq, tk, tv, n)) for n in variants}
    turns["ours-capture"] = lambda: attention.attention_with_capture(tq, tk, tv)
    turns["SDPA forward"] = lambda: F.scaled_dot_product_attention(tq, tk, tv)
    kernels = {n: ("attention_variants", ks) for n, ks in variants.items()}
    kernels["ours-capture"] = ("attention", ("flash_fwd", "attn_mean"))
    meds, reads = in_turns(*turns.values())
    bound = max((4 * tq.numel() * 2 + b * t * t * 2) / PEAK_BYTES,
                4.0 * b * h * t * t * d / PEAK_BF16) * 1e3
    floor = 2.0 * b * h * t * t / exp_rate * 1e3
    for (name, med), got in zip(zip(turns, meds), reads):
        src, names = kernels.get(name, (None, ()))
        regs = "; ".join(registers(src, k) for k in names) or "a library kernel (out only)"
        split = kernel_split(turns[name], names)
        parts = " + ".join(f"{k} {split[k]:.4f} ms" if k in split else f"{k} not measured"
                           for k in names)
        log(f"[time] tool shape {tuple(tq.shape)}, {name}: {med:.4f} ms = {med / bound:.2f}x the "
            f"bound ({bound:.4f} ms, ops) = {med / floor:.2f}x the two-pass exp floor "
            f"({floor:.4f} ms){'; device ms per launch, profiled: ' + parts if parts else ''}; "
            f"{regs}; readings in turns {[round(x, 4) for x in got]}")
    return dict(zip(turns, meds))


def kernel_split(fn, names, calls: int = 3) -> dict:
    """Device ms per launch of each of the kernels ``names`` (functions of
    a csrc/ source's anonymous namespace) over ``calls`` profiled calls of
    ``fn`` (the profiler can miss the first launch of its window, so the
    time is divided by the launches it saw); a name it did not see is left
    out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not names:
        return {}
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    split = {}
    for n in names:
        seen = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and f"::{n}(" in e.key]
        if seen:
            split[n] = sum(e.self_device_time_total for e in seen) / sum(e.count for e in seen) / 1e3
    return split


def phase_main_path_inputs(results: dict, handed: dict) -> None:
    """CCL and mean-shift on the inputs ``seed_pseudo_gt`` handed them
    (phase 4), checked against their plain versions (``check_meanshift_on``)
    and timed in turns with the same kernels on phase 3's synthetic
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
    expect("main-input.ccl_batch", max_err(ccl.connected_components_batch(masks, iters),
                                           ccl.connected_components(masks, iters)), 0.0,
           "integer labels: exact")
    margs, mkw = handed["cosine_shift_fixpoint"]
    check_meanshift_on("main-input", margs, mkw)
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


# torch.profiler ranges the port opens (record_function): the NMS fixpoint's loop
PROFILER_RANGES = ("nms.while_loop",)


def host_reads_under(events, name: str) -> int:
    """Host reads of a device scalar (``aten::_local_scalar_dense``: each
    ``bool()`` / ``item()`` of a CUDA tensor waits for the stream) made
    inside the profiler range ``name``."""
    n = 0
    for e in events:
        if e.name != "aten::_local_scalar_dense":
            continue
        p = e.cpu_parent
        while p is not None and p.name != name:
            p = p.cpu_parent
        n += p is not None
    return n


def profile_slice(run, ms_img: float, top: int = 12, what: str = "call",
                  events: list | None = None):
    """Where one call's time goes: device time by kernel (torch.profiler;
    the ``top`` kernels and every hand-written one) and the device's busy
    share of the call's wall time. Returns the profile's ``key_averages()``
    and the busy share (None when the profiler saw no device time); the
    profile's events go into ``events`` when it is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if events is not None:
        events.extend(prof.events())
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


def ablated(entry: str, variant: str) -> bool:
    """Whether the tool's ``variant`` is built and timed with the
    ``ABLATIONS["attention_variants"]`` entry: "as built" always, an entry
    named "vN: ..." for variant vN only, the others (constants of the
    two-pass design) for every variant but v5."""
    if entry == "as built":
        return True
    head = entry.split(":")[0]
    if head in ("v2", "v3", "v4", "v5", "v6"):
        return variant.startswith(head + "-")
    return variant != "v5-batched"


def phase_ablation(sources) -> None:
    """Design constants: each source of ``ABLATIONS`` built once per
    variant (all builds started together), each variant checked against
    the plain version at the bench shape (limits of phase 3), then read in
    turns: the forward pair's flash pass beside SDPA's forward with the
    same mask and its mean pass; the microbenchmark's variants on its
    inputs (``ablated``: which entries each takes) beside the shipped
    capture pair and SDPA's forward there; the mean-shift fixpoint (bf16)
    and CCL on phase 3's inputs."""
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
    if "attention_variants" in sources:
        from attentionshift_torch.ops import attention_variants as av
        from attentionshift_torch.tools.analysis.microbench_attention import make_inputs

        vlibs = {n: av.variant_library(d) for n, d in ABLATIONS["attention_variants"].items()}
        tq, tk, tv = make_inputs(device=dev)
        b, h, t, _ = tq.shape
        for n, lib in vlibs.items():
            if ablated(n, "v5-batched"):
                log(f"[ablate] v5-batched, {n}: clusters of {lib.attn_v5_cluster(b, h, t)} blocks")
        for variant in av.VARIANTS:
            want_out, want_mean = av.variant_reference(tq, tk, tv, variant)
            limit = av.mean_limit(tq, tk, variant, want_mean)
            for n, lib in vlibs.items():
                if not ablated(n, variant):
                    continue
                fns[f"{variant}, {n}"] = (lambda lib=lib, variant=variant:
                                          av.attention_variant(tq, tk, tv, variant, lib=lib))
                out, mean = av.attention_variant(tq, tk, tv, variant, lib=lib)
                sync()
                expect(f"{variant}, {n}: out", max_err(out, want_out), bf16_ulps(want_out, 4),
                       "4 bf16 ulps of the largest |out|")
                expect_mean(f"{variant}, {n}: mean", mean, want_mean, limit)
                del out, mean
            del want_out, want_mean, limit
        fns["tool shape, ours-capture"] = lambda: attention.attention_with_capture(tq, tk, tv)
        fns["tool shape, SDPA forward (out only)"] = lambda: F.scaled_dot_product_attention(
            tq, tk, tv)
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


# tensor, sequence and pipeline parallelism over a model group of two ranks
# that share the one card over gloo (NCCL refuses two ranks on one device):
# per rank, the kernels #1, #2, #5, #6 launched on each path
PAR_RANKS = 2
PAR_BLOCK = 6  # the block whose q, k, v (column), fc2 (row) and norm1 gradients are held
PAR_FWD_LAUNCHES = {"attention_capture": CAM_LAYERS, "attention_plain": 12 - CAM_LAYERS}
PAR_PP_LAUNCHES = {"attention_capture": 12 // PAR_RANKS * 2}  # 6 blocks x 2 microbatches
PAR_STEP_LAUNCHES = TRAIN_LAUNCHES  # one train step, every kernel of the path on each rank
PAR_KERNELS = ("attention_capture", "attention_plain", "attention_bwd_dq", "attention_bwd_dkv")


def rel_dist(a, ref) -> float:
    """max |a - ref| over max |ref|."""
    return max_err(a, ref) / max(float(ref.float().abs().max()), 1e-30)


def within_rounding(tag: str, got, single, ref32, control=None, witness=None) -> tuple:
    """(ok, line): ``got`` (a sharded path, bf16) no further from the f32
    plain path ``ref32`` than 1.5x the single-rank bf16 path ``single`` is,
    plus 1e-3 of the largest value: what bf16 rounding alone gives is the
    witness (``witness``, when given, replaces the single-rank path's own
    distance). ``control`` must fail the same limit."""
    why = "the single-rank bf16 path's" if witness is None else "the step's largest loss move"
    witness = rel_dist(single, ref32) if witness is None else witness
    dist = rel_dist(got, ref32)
    limit = 1.5 * witness + 1e-3
    ok = dist <= limit
    line = (f"[check] {tag}: {dist:.4e} of the largest value from the f32 plain path, witness "
            f"{witness:.4e} ({why} under bf16; limit 1.5x + 1e-3)")
    if control is not None:
        cdist = rel_dist(control, ref32)
        ok = ok and cdist > limit
        line += f"; control {cdist:.4e}, must exceed {limit:.4e}"
    return ok, line + (": ok" if ok else ": FAIL")


def parallel_worker(rank: int, out: str) -> None:
    """One rank of ``phase_parallel``: the TP, SP and PP forwards and the
    dp1 x tp2 x sp train step of the VOC flagship at the bench geometry,
    each checked on rank 0 against the single-rank path on the card; its
    check lines, ms, launches and staging times to ``out/rank{rank}.json``."""
    import contextlib
    import copy
    from unittest import mock

    import torch

    from attentionshift_torch.models import layers
    from attentionshift_torch.models.vit import vit_forward_pp
    from attentionshift_torch.ops._build import reset_launches
    from attentionshift_torch.ops.attention import attention_with_capture, capture_mean_limit
    from attentionshift_torch.parallel import collectives, mesh as pmesh, pp as pp_mod
    from attentionshift_torch.parallel.tp import (TPContext, scatter_to_sp, shard_params_tp,
                                                  shard_tensor)
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step
    from attentionshift_torch.train import step as step_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, world, dev = pmesh.init_distributed(torch.device("cuda"))
    import torch.distributed as dist

    assert world == PAR_RANKS and dist.get_backend() == "gloo", (world, dist.get_backend())
    mesh = pmesh.make_mesh(1, PAR_RANKS)
    tp = TPContext(mesh.model_group, PAR_RANKS, rank)
    lines, paths, failed = [], {}, []

    def note(ok_line):
        """Print a check's line as it comes; failures raise at the end."""
        ok, line = ok_line
        log(line)
        lines.append(line)
        if not ok:
            failed.append(line)

    inp = slice_inputs(H_IMG, W_IMG, MAX_GT, N_VALID, dev)
    img = inp[0]
    base = build_model(dev, torch.bfloat16)
    keys = ("last_feat", "outputs_class", "point_tokens")

    def run_path(name: str, fn):
        """``fn()`` with the launch counts at 0 and read after, its host ms
        (synchronised; both ranks start it together) and the staging
        counters."""
        sync()
        dist.barrier()
        reset_launches()
        collectives.reset_staging()
        t0 = time.perf_counter()
        res = fn()
        sync()
        paths[name] = dict(ms=(time.perf_counter() - t0) * 1e3, launches=launch_counts(),
                           staging=dict(collectives.STAGING))
        return res

    # the single-rank references: bf16 on the kernels (on both ranks: its
    # first call also loads the kernels and the libraries before any timed
    # path), f32 on the plain path (rank 0)
    with torch.no_grad():
        single = base.backbone(img)
    ref32 = None
    if rank == 0:
        m32 = build_model(dev, torch.float32)
        for blk in m32.backbone.blocks:
            blk.attn.use_kernel = False
        with torch.no_grad():
            ref32 = m32.backbone(img)
        del m32

    def sharded(sp: bool):
        m = copy.deepcopy(base)
        m.backbone.sequence_parallel = sp
        shard_params_tp(m, mesh)
        return m

    # the TP forward: the capture maps on the path's own q, k, v of each layer
    handed = []
    real = layers.attention_with_capture_sharded

    def keep(q, k, v, pad_interval=None, tpc=None):
        o, mean = real(q, k, v, pad_interval, tpc)
        handed.append((q.detach(), k.detach(), v.detach(), mean, pad_interval))
        return o, mean

    tpm = sharded(False)
    with torch.no_grad(), mock.patch.object(layers, "attention_with_capture_sharded", keep):
        out_tp = run_path("tp_forward", lambda: tpm.backbone(img))
    for i, (q, k, v, mean, gap) in enumerate(handed):
        full = [collectives.all_gather(t.contiguous(), tp.group, dim=1) for t in (q, k, v)]
        local = attention_with_capture(q, k, v, gap)[1]  # the control: this rank's heads only
        if rank == 0:
            want = attention_with_capture(*full, gap)[1]
            limit = capture_mean_limit(want)
            over, cover = mean_over(mean, want, limit), mean_over(local, want, limit)
            ok = over <= 1.0 < cover
            note((ok, f"[check] parallel.tp capture layer {i}: the mean over 3 + 3 heads, "
                      f"all-reduced, against the single-rank kernel on the gathered q, k, v: "
                      f"worst entry at {over:.3f}x its limit (capture_mean_limit); control "
                      f"(this rank's 3 heads, not reduced) at {cover:.1f}x, must exceed 1: "
                      f"{'ok' if ok else 'FAIL'}"))
    del handed
    with torch.no_grad(), mock.patch.object(layers, "reduce_from_tp", lambda y, tpc: y):
        ctl = tpm.backbone(img)  # the control: row-parallel partial sums not reduced
    if rank == 0:
        for key in keys:
            note(within_rounding(f"parallel.tp.{key}", out_tp[key], single[key], ref32[key],
                                 ctl[key]))
    del tpm, out_tp, ctl

    # the SP forward: 2176 of the 4352 tokens on each rank between the blocks;
    # the control slices each row-parallel layer's partial sums to the
    # rank's tokens instead of reduce-scattering them
    not_scattered = mock.patch.object(layers, "reduce_scatter_sp", scatter_to_sp)
    spm = sharded(True)
    with torch.no_grad():
        out_sp = run_path("sp_forward", lambda: spm.backbone(img))
        with not_scattered:
            ctl = spm.backbone(img)
    if rank == 0:
        for key in keys + ("attns",):
            note(within_rounding(f"parallel.sp.{key}", out_sp[key], single[key], ref32[key],
                                 ctl[key]))
    del spm, out_sp, ctl

    # the PP forward: 2 stages x 2 microbatches at batch 2 (the bench image twice)
    # (the control: the stages swapped, each rank running the other's blocks)
    img2 = img.expand(2, -1, -1, -1).contiguous()
    out_pp = run_path("pp_forward", lambda: vit_forward_pp(base.backbone, img2, tp, 2))
    with mock.patch.object(pp_mod, "shard_stage_params",
                           lambda st, tpc: {n: t[tpc.size - 1 - tpc.rank] for n, t in st.items()}):
        ctl = vit_forward_pp(base.backbone, img2, tp, 2)
    if rank == 0:
        for key in keys:
            for b in range(2):
                note(within_rounding(f"parallel.pp.{key}[{b}]", out_pp[key][b:b + 1],
                                     single[key], ref32[key], ctl[key][b:b + 1]))
    del out_pp, ctl, img2

    # the dp1 x tp2 x sp train step against the single-rank step (same draws)
    batch = dict(zip(("img", "gt_points", "gt_labels", "gt_valid", "img_wh"), inp))
    names = [f"backbone.blocks.{PAR_BLOCK}.{n}" for n in ("attn.qkv.weight", "mlp.fc2.weight",
                                                          "norm1.weight")]

    def one_step(model, group, reduce_partial=True, path=None, fault=contextlib.nullcontext()):
        opt = build_optimizer(model, base_lr=1e-4, steps_per_epoch=100, accumulate_steps=1,
                              depth=12)
        state = TrainState.create(model, opt)
        if group is not None:
            state = pmesh.place_state(state, mesh)
        seen = {}
        inner = opt.step

        def spy(grads):
            seen.update({n: g.detach().float().clone() for n, g in zip(opt.names, grads)
                         if n in names})
            return inner(grads)

        opt.step = spy
        fn = make_train_step(model, group)
        gen = torch.Generator(device=dev).manual_seed(1)
        partial = (step_mod.reduce_partial_grads if reduce_partial
                   else (lambda nm, grads, part, tpc: grads))
        with mock.patch.object(step_mod, "reduce_partial_grads", partial), fault:
            call = lambda: fn(state, batch, generator=gen)[1]  # noqa: E731
            metrics = run_path(path, call) if path else call()
        return {k: float(v) for k, v in metrics.items()}, seen

    step_ref = step32 = None
    if rank == 0:
        step_ref = one_step(copy.deepcopy(base), None)
        m32 = build_model(dev, torch.float32)
        for blk in m32.backbone.blocks:
            blk.attn.use_kernel = False
        step32 = one_step(m32, None)
        del m32

    def tp_step(reduce_partial=True, path=None, fault=contextlib.nullcontext()):
        m = copy.deepcopy(base)
        m.backbone.sequence_parallel = True
        return one_step(m, mesh, reduce_partial, path, fault)

    got = tp_step(path="train_step")
    ctl = tp_step(reduce_partial=False)  # the SP LayerNorm gradient not reduced
    ctl_fwd = tp_step(fault=not_scattered)  # the SP forward's control, in the step
    if rank == 0:
        (lt, gt), (ls, gs), (l32, g32), (_, gc) = got, step_ref, step32, ctl
        losses = [k for k in sorted(l32) if k.startswith("loss")]
        # one scalar is a poor sample of rounding noise: the witness of the
        # losses is the largest move bf16 gives any loss of this step, and
        # the total, with the control, shows that this limit still catches a
        # wrong forward
        moved = max(rel_dist(torch.tensor(ls[k]), torch.tensor(l32[k])) for k in losses)
        for key in losses:
            note(within_rounding(f"parallel.step.{key}", torch.tensor(lt[key]),
                                 torch.tensor(ls[key]), torch.tensor(l32[key]),
                                 torch.tensor(ctl_fwd[0][key]) if key == "loss_total" else None,
                                 witness=moved))
        # the controls of the gradients: qkv's contiguous chunk (the JAX
        # spec's literal layout: all of q and half of k), fc2's other shard,
        # the LayerNorm gradient not reduced
        qkv, fc2, norm = names
        controls = {qkv: gs[qkv].chunk(2, dim=0)[0], fc2: shard_tensor(fc2, gs[fc2], 1, 1, 2),
                    norm: gc[norm]}
        for n, axis in zip(names, (0, 1, None)):
            cut = (lambda t: t) if axis is None else (lambda t: shard_tensor(n, t, axis, 0, 2))
            note(within_rounding(f"parallel.step.grad[{n}]", gt[n], cut(gs[n]), cut(g32[n]),
                                 controls[n]))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(lines=lines, paths=paths), f)
    dist.destroy_process_group()
    if failed:
        raise AssertionError("parallel checks failed:\n" + "\n".join(failed))


def phase_parallel(smi: str) -> dict:
    """Tensor, sequence and pipeline parallelism (``parallel/``) at the VOC
    flagship's full width (ViT-S at 800x1344, T = 4352): two ranks share
    the card over gloo (``parallel_worker``, this script run twice with
    ``--parallel-rank``), the kernels on the card in each, only the
    collectives through the host. The TP forward (3 heads per rank), the SP
    forward (2176 tokens per rank), the PP forward (2 stages x 2
    microbatches at batch 2) and one dp1 x tp2 x sp train step, each
    against the single-rank path (``within_rounding``; the capture maps per
    entry within ``capture_mean_limit``), each with a control that must
    miss: the capture mean and the row-parallel sums not reduced (TP), the
    row-parallel partial sums sliced to the rank's tokens instead of
    reduce-scattered (SP, and the step's total loss), the two stages
    swapped (PP), the qkv gradient against its contiguous chunk, the fc2
    gradient against the other rank's shard, the SP LayerNorm gradient not
    reduced. Per path and rank: host ms, launches of #1, #2, #5, #6
    (asserted) and the gloo staging time. Returns the launches summed over
    paths and ranks."""
    import socket
    import tempfile

    out = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    procs = []
    for rank in range(PAR_RANKS):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(PAR_RANKS),
                   MASTER_ADDR="localhost", MASTER_PORT=port, ATTNSHIFT_DIST_BACKEND="gloo")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank", str(rank), out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=900)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for line in logs[0].splitlines():
        if line.startswith("[check]"):
            log(line)
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel rank {rank} failed ({p.returncode}):\n{text[-6000:]}")
    res = []
    for rank in range(PAR_RANKS):
        with open(os.path.join(out, f"rank{rank}.json")) as f:
            res.append(json.load(f))
    want = dict(tp_forward=PAR_FWD_LAUNCHES, sp_forward=PAR_FWD_LAUNCHES,
                pp_forward=PAR_PP_LAUNCHES, train_step=PAR_STEP_LAUNCHES)
    total = {name: 0 for name in expected_launches()}
    for rank, r in enumerate(res):
        for path, counts in want.items():
            got = r["paths"][path]
            if got["launches"] != expected_launches(**counts):
                raise AssertionError(f"parallel {path} rank {rank}: launches "
                                     f"{nonzero(got['launches'])} != {counts}")
            for name, n in got["launches"].items():
                total[name] += n
            st = got["staging"]
            log(f"[parallel] {smi}: {path} rank {rank}: {got['ms']:.2f} ms (host clock, "
                f"synchronised; the collectives stage through the host under gloo, so this is "
                f"not a speed), launches " + ", ".join(f"{k} {got['launches'][k]}"
                                                       for k in PAR_KERNELS)
                + f"; gloo staging {st.get('calls', 0)} calls, {st.get('bytes', 0) / 2**20:.1f} "
                f"MiB, host copies {st.get('copy_ms', 0.0):.2f} ms, collectives "
                f"{st.get('collective_ms', 0.0):.2f} ms")
    log(f"[parallel] two ranks on one card: {wall:.1f} s wall (process start, build, references "
        f"and checks included)")
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    return total


# the diagnosis and profiling twins (phase_diagnosis): run lengths cut as
# listed, every size their defaults; DIAG_*_ARGV add arguments (a rehearsal
# on the CPU passes small sizes there)
DIAG_STEPS = 3  # timed calls per profiled stage (after one warm-up call)
DIAG_TRAIN_STEPS = 20  # diagnose_det and probe_rpn
DIAG_FID_STEPS = 10  # fidelity_study's inline training
DIAG_EVAL = 2  # held-out images of diagnose_det and fidelity_study
DIAG_SEED_ARGV: list = []
DIAG_BACKBONE_ARGV: list = []
DIAG_STAGE_A_ARGV: list = []
DIAG_STAGE_BC_ARGV: list = []
DIAG_CALIBRATE_ARGV: list = []
DIAG_FID_ARGV: list = []
DIAG_EXACT_PLANE = (512, 512)  # the exact config's CCL planes: stride 1 at 512x512
DIAG_TRACE_KERNELS = ("flash_fwd", "attn_mean", "ccl_kernel", "meanshift_kernel")


def recording_all(module, name: str, store: list):
    """Patch ``module.name`` with a pass-through that appends a copy of
    every call's arguments to ``store``."""
    from unittest import mock

    import torch

    fn = getattr(module, name)

    def record(*args, **kwargs):
        store.append(([a.detach().clone() if torch.is_tensor(a) else a for a in args],
                      dict(kwargs)))
        return fn(*args, **kwargs)

    return mock.patch.object(module, name, record)


def launches_of(counts: dict) -> dict:
    """Every kernel's count of a path from per-unit counts and their
    multiples: ``{(counts dict): times, ...}`` summed."""
    total = expected_launches()
    for per, times in counts:
        for k, v in per.items():
            total[k] += v * times
    return total


def run_counted(tag: str, fn, want: dict, total: dict):
    """``fn()`` with the launch counts at 0 just before; its launches must
    be ``want`` and are added to ``total``. Returns (its result, wall s)."""
    from attentionshift_torch.ops._build import reset_launches

    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    got = launch_counts()
    if got != want:
        raise AssertionError(f"{tag}: launches {nonzero(got)} != {nonzero(want)}")
    for k, v in got.items():
        total[k] += v
    log(f"[diagnosis] {tag}: {wall:.1f} s wall, launches {nonzero(got)}: ok")
    return out, wall


def ccl_cut_planes(calls: list) -> dict:
    """Per (plane shape, sweep cap) of the recorded CCL calls: the planes
    whose labels the kernel changes at one sweep more (cut by the cap),
    and all planes."""
    from attentionshift_torch.ops import ccl
    from attentionshift_torch.tools.analysis.fidelity_study import cut_planes

    cut = {}
    for (masks, *rest), kw in calls:
        cap = int(kw.get("max_iters", rest[0] if rest else 256))
        key = (tuple(masks.shape[1:]), cap)
        c, n = cut.get(key, (0, 0))
        cut[key] = (c + cut_planes(ccl.connected_components_batch(masks, cap),
                                   ccl.connected_components_batch(masks, cap + 1)),
                    n + masks.shape[0])
    sync()
    return cut


def phase_diagnosis(results: dict, smi: str) -> dict:
    """The diagnosis and profiling twins on the card at their JAX defaults
    (full width), run lengths cut: ``profile_seed``, ``profile_backbone``,
    ``profile_stage_a``, ``profile_stage_bc`` with ``--steps 3``, each with
    its exact launches of #1-#4 per call asserted and its kernels held
    against their plain versions on the tool's own inputs (the backbone's
    q, k, v through both attention pairs, forward and backward, at its odd
    T = 4301); ``calibrate_overhead``; ``trace_ops`` on a ``torch.profiler``
    trace of one ``seed_pseudo_gt`` call, whose kernel rows must name
    ``flash_fwd``, ``attn_mean``, the CCL and the mean-shift kernels;
    ``warm_cache`` (every library cached by now); ``diagnose_det`` (20
    steps, 2 + 2 images), its both attention pairs on its own q, k, v;
    ``probe_rpn`` with ``--save-ckpt``, then ``--ckpt`` on that file (the
    two reports equal); ``fidelity_study`` (10 inline steps, 2 images,
    ``--out`` in a temporary directory): its launches, CCL on a
    full-resolution (56, 512, 512) plane batch of the exact config against
    the plain version, and the planes each CCL configuration's sweep cap
    cut (kernel at the cap against one sweep more). Stage times beside the
    card's name and power limit. Returns the phase's launches."""
    import shutil
    import tempfile

    import torch

    from attentionshift_torch.models import layers
    from attentionshift_torch.pseudo import engine, meanshift
    from attentionshift_torch.tools import warm_cache
    from attentionshift_torch.tools.analysis import (
        calibrate_overhead, diagnose_det, fidelity_study, probe_rpn, profile_backbone,
        profile_seed, profile_stage_a, profile_stage_bc, trace_ops)

    total = expected_launches()
    calls = 1 + DIAG_STEPS
    seed, train = SEED_LAUNCHES, TRAIN_LAUNCHES
    bb = {"attention_capture": CAM_LAYERS, "attention_plain": 12 - CAM_LAYERS}
    steps = ["--steps", str(DIAG_STEPS)]

    # ---- the four profiling twins
    handed: dict = {}
    with kernel_inputs_of(handed):
        prof, _ = run_counted("profile_seed", lambda: profile_seed.main(steps + DIAG_SEED_ARGV),
                              launches_of([(bb, 2 * calls), (dict(ccl_batch=1), calls),
                                           (seed, calls)]), total)
    check_kernels_on("profile_seed-input", handed)
    log(f"[diagnosis] profile_seed (ms per call, host clock, {DIAG_STEPS} calls after one): "
        f"{ {k: round(v, 3) for k, v in prof['times'].items()} }; {smi}")
    res, _ = run_counted("profile_backbone",
                         lambda: profile_backbone.main(steps + DIAG_BACKBONE_ARGV),
                         launches_of([({"attention_capture": 7}, calls),
                                      ({"attention_plain": 5}, calls)]), total)
    q, k, v = (res["inputs"][n] for n in "qkv")
    g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(5),
                    device=q.device).bfloat16()
    errs = check_attention_pair("profile_backbone-input.pair", q, k, v, g, None, quiet=True)
    for name, key in (("attention_capture", "capture"), ("attention_plain", "plain"),
                      ("attention_bwd_dq", "dq"), ("attention_bwd_dkv", "dkv")):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], errs[key])
    log(f"[diagnosis] profile_backbone at {tuple(q.shape)}: "
        f"{ {k: round(v, 3) for k, v in res['times'].items()} } ms; {smi}")
    del res, q, k, v, g
    handed = {}
    with recording(engine, "connected_components_batch", handed):
        res, _ = run_counted("profile_stage_a",
                             lambda: profile_stage_a.main(steps + DIAG_STAGE_A_ARGV),
                             launches_of([(dict(ccl_batch=1), calls)]), total)
    check_kernels_on("profile_stage_a-input", handed)
    log(f"[diagnosis] profile_stage_a: { {k: round(v, 3) for k, v in res['times'].items()} } ms; "
        f"{smi}")
    del res
    handed = {}
    with recording(meanshift, "cosine_shift_fixpoint", handed):
        res, _ = run_counted("profile_stage_bc",
                             lambda: profile_stage_bc.main(steps + DIAG_STAGE_BC_ARGV),
                             launches_of([(dict(meanshift_fixpoint=1), calls)]), total)
    check_kernels_on("profile_stage_bc-input", handed)
    log(f"[diagnosis] profile_stage_bc: { {k: round(v, 3) for k, v in res['times'].items()} } "
        f"ms; {smi}")
    res, _ = run_counted("calibrate_overhead",
                         lambda: calibrate_overhead.main(DIAG_CALIBRATE_ARGV), expected_launches(),
                         total)
    log(f"[diagnosis] calibrate_overhead: { {k: round(v, 4) for k, v in res['times'].items()} } "
        f"ms; {smi}")

    # ---- trace_ops on a profiled seed_pseudo_gt call
    from torch.profiler import ProfilerActivity, profile

    args = profile_seed.parse_args(DIAG_SEED_ARGV)
    dev = torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    model = profile_seed.build_model(args, dev)
    inp = profile_seed.make_inputs(args.height, args.width, args.max_gt, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        def traced():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                model.seed_pseudo_gt(*inp, generator=torch.Generator(device=dev).manual_seed(5))
                sync()
            os.makedirs(os.path.join(tmp, "run"))
            p.export_chrome_trace(os.path.join(tmp, "run", "seed.json"))

        run_counted("traced seed_pseudo_gt", traced, launches_of([(seed, 1)]), total)
        rep = trace_ops.main([tmp, "--top", "15", "--device", dev.type])
        names = list(rep["per_op"])
        missing = [kname for kname in DIAG_TRACE_KERNELS if not any(kname in n for n in names)]
        if dev.type == "cuda" and (rep["lane"] != "kernel" or missing):
            raise AssertionError(f"trace_ops: no row of {missing} among {names}")
        log(f"[diagnosis] trace_ops: {rep['n_events']} {rep['lane']} events, {len(names)} rows, the "
            f"hand-written kernels' rows: "
            f"{ {n: round(t / 1e3, 4) for n, t in rep['per_op'].items() if any(kn in n for kn in DIAG_TRACE_KERNELS)} } "
            f"ms: ok")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, inp

    rows, _ = run_counted("warm_cache", lambda: warm_cache.main([]), expected_launches(), total)
    kernels = [r for r in rows if not os.path.basename(r[0]).startswith("maskapi")]
    if dev.type == "cuda" and not (kernels and all(cached for _, cached, _ in kernels)):
        raise AssertionError(f"warm_cache: a kernel library built again after phase 2: {rows}")

    # ---- diagnose_det, probe_rpn
    handed = {}
    n_train, n_eval = DIAG_TRAIN_STEPS, DIAG_EVAL
    with kernel_inputs_of(handed):
        rows, _ = run_counted(
            "diagnose_det",
            lambda: diagnose_det.main(["--steps", str(n_train), "--train-images", "2",
                                       "--eval-images", str(n_eval)]),
            launches_of([(train, n_train), ({"attention_plain": 36}, n_eval)]), total)
    if len(rows) != n_eval or any(not 0 <= r["n_det"] <= 100 for r in rows):
        raise AssertionError(f"diagnose_det rows {rows}")
    log(f"[diagnosis] diagnose_det rows: {rows}")
    q, k, v = (x.contiguous() for x in handed["attention_with_capture"][0][:3])
    g = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(6),
                    device=q.device).bfloat16()
    check_attention_pair("diagnose_det-input.pair", q, k, v, g, None, quiet=True)
    log(f"[diagnosis] both attention pairs on diagnose_det's own q, k, v {tuple(q.shape)}: ok")
    del handed, q, k, v, g
    tmp = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    try:
        ckpt = os.path.join(tmp, "probe.pt")
        probe = {"attention_capture": 14, "attention_plain": 22, "ccl_batch": 1,
                 "meanshift_fixpoint": 1}
        first, _ = run_counted(
            "probe_rpn --save-ckpt",
            lambda: probe_rpn.main(["--steps", str(n_train), "--save-ckpt", ckpt]),
            launches_of([(train, n_train), (probe, 2)]), total)
        again, _ = run_counted("probe_rpn --ckpt", lambda: probe_rpn.main(["--ckpt", ckpt]),
                               launches_of([(probe, 2)]), total)
        if first != again:
            raise AssertionError(f"probe_rpn: the restored report differs:\n{first}\n{again}")
        log(f"[diagnosis] probe_rpn: the report after --ckpt equals the trained run's: ok; "
            f"{[{k: r[k] for k in ('tag', 'n_valid_props', 'pseudo_vs_true_iou', 'rpn_train_n_pos')} for r in first]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- fidelity_study
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fidelity_")
    handed, ccl_calls = {}, []
    try:
        out = os.path.join(tmp, "fidelity.md")
        per_image = launches_of([(seed, 4), (dict(ccl_batch=3, meanshift_fixpoint=2), 1)])
        with kernel_inputs_of(handed), recording_all(engine, "connected_components_batch",
                                                      ccl_calls):
            rep, _ = run_counted(
                "fidelity_study",
                lambda: fidelity_study.main(["--train-steps", str(DIAG_FID_STEPS),
                                             "--eval-images", str(DIAG_EVAL), "--out", out,
                                             *DIAG_FID_ARGV]),
                launches_of([(train, DIAG_FID_STEPS), (per_image, DIAG_EVAL),
                             (dict(meanshift_fixpoint=1), 32)]), total)
        if os.listdir(tmp) != ["fidelity.md"]:
            raise AssertionError(f"fidelity_study wrote {os.listdir(tmp)}")
        log(f"[diagnosis] fidelity_study: end_to_end {rep['end_to_end']}, isolated_stride "
            f"{ {k: rep['isolated_stride'][k] for k in ('pseudo_mask_iou', 'stage_a_box_iou_all_layers', 'stage_a_box_iou_stride16')} }")
        exact = [c for c in ccl_calls if tuple(c[0][0].shape[1:]) == DIAG_EXACT_PLANE]
        if not exact:
            raise AssertionError("fidelity_study: no CCL call of the exact config")
        # mean-shift's last call here is a constructed scene without parts
        # (no control could fail there): it is held on the profiling inputs
        handed.pop("cosine_shift_fixpoint", None)
        shapes = check_kernels_on("fidelity-input", dict(handed, connected_components_batch=exact[-1]))
        cut = ccl_cut_planes(ccl_calls)
        log(f"[diagnosis] fidelity_study CCL planes cut by the sweep cap (kernel at the cap "
            f"against one sweep more), per (plane, cap): "
            f"{ {f'{s[0]}x{s[1]} cap {c}': v for (s, c), v in sorted(cut.items())} }; the "
            f"exact config's planes {shapes['ccl_planes']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[diagnosis] launches of the phase: {nonzero(total)}")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablate", nargs="*", metavar="SOURCE",
                    help="only the ablation of design constants, every variant of each source "
                         "of ABLATIONS (default: all sources)")
    ap.add_argument("--parallel-rank", nargs=2, metavar=("RANK", "DIR"),
                    help=argparse.SUPPRESS)  # one rank of phase_parallel
    ap.add_argument("--only", choices=["diagnosis"],
                    help="only the card, the build and this phase (no kernel line, no result)")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    if not os.path.isdir(os.path.join(HERE, "attentionshift_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    import torch

    from attentionshift_torch.ops._build import KERNELS

    if args.parallel_rank:
        parallel_worker(int(args.parallel_rank[0]), args.parallel_rank[1])
        return 0
    smi = phase_card()
    if args.ablate is not None:
        phase_ablation(args.ablate or list(ABLATIONS))
        log(smi)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    if args.only == "diagnosis":
        phase_diagnosis({name: {"max_abs_err": 0.0} for name in KERNELS}, smi)
        log(smi)
        return 0
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
    phase_refine_reference(dev)
    rc = phase_refine_cli(tc, smi)
    cc = phase_coco_cli(smi)
    vc = phase_variant_cli(tc, smi)
    cascade = phase_cascade_step(dev, smi)
    vitb = phase_vitb_cli(cc, smi)
    sw = phase_swin(dev, smi)
    for name, key in (("attention_capture_d32", "capture"), ("attention_plain_d32", "plain"),
                      ("attention_bwd_dq_d32", "dq"), ("attention_bwd_dkv_d32", "dkv")):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], sw["errs"][key])
    phase_bank(dev)
    p2b = phase_point2bbox(dev, model, smi)
    phase_crf(dev, p2b)
    del p2b["out"]
    phase_point_generator(dev)
    mae = phase_mae_encoder(dev, smi)
    mim = phase_mim(dev, smi)
    phase_det_cam(dev, model, smi)
    phase_vis_tools(tc, ev)
    learning = phase_learning(smi)
    export = phase_export(smi)
    tools = phase_user_tools(ev, smi)
    parallel = phase_parallel(smi)
    diagnosis = phase_diagnosis(results, smi)
    phase_times(results, inp, model, slice_inp, gen)
    phase_swin_times(results, sw, smi)
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
    variants = dict(coco_cli=cc["total"], teacher_cli=vc["ts"], keypoint_cli=vc["keypoint"],
                    cascade_step=cascade, vitb_cli=vitb, swin=sw["launches"],
                    point2bbox=p2b["launches"], mae_encoder=mae["launches"], mim=mim["launches"],
                    debug_overfit=learning["debug_overfit"],
                    learning_check=learning["learning_check"], export=export, user_tools=tools,
                    parallel=parallel, diagnosis=diagnosis)
    table = []
    for name, kern in KERNELS.items():
        r = results[name]
        # launches: each path was driven with the counts at 0 and read right after
        table.append(dict(name=name, route="cuda", source=f"attentionshift_torch/csrc/{kern.source}.cu",
                          replaces=kern.replaces,
                          launches=(seed_launches[name] + infer_launches[name]
                                    + train_launches[name] + tool_launches[name]
                                    + eval_single[name] + eval_aug[name] + train_cli[name]
                                    + pseudo_cli[name] + rc["train"][name] + rc["eval"][name]
                                    + sum(v[name] for v in variants.values())),
                          launches_seed_pseudo_gt=seed_launches[name],
                          launches_simple_test=infer_launches[name],
                          launches_train_steps=train_launches[name],
                          launches_microbench_tool=tool_launches[name],
                          launches_eval_single=eval_single[name],
                          launches_eval_aug_test=eval_aug[name],
                          launches_train_cli=train_cli[name],
                          launches_gen_pseudo_labels=pseudo_cli[name],
                          launches_refine_train=rc["train"][name],
                          launches_refine_eval=rc["eval"][name],
                          **{f"launches_{k}": v[name] for k, v in variants.items()},
                          max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                          bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"],
                          **{key: r[key] for key in ("mean_pass_ms", "ms_main_path_input",
                                                     "eval_path_T", "exp_floor_ms",
                                                     "mean_pass_ms_24_heads_streamed",
                                                     "mean_pass_ms_12_heads_resident")
                             if key in r}))
    log(smi)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
