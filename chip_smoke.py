"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
1. the card's name and power limit (nvidia-smi);
2. build every kernel of ``attentionshift_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all at once;
3. each kernel at the bench shapes against its plain PyTorch version on
   the card, with the tolerance stated beside each check;
4. ``AttnShiftDetector.seed_pseudo_gt`` at the full width of
   ``configs/attnshift_voc12aug.py`` (ViT-S) with seeded random weights,
   800x1344, bf16: output shapes, finite maps, and kernel launch counts
   of the main path (exactly 7/5/1/1 per image);
5. times with CUDA events: every kernel, its plain version, the library
   call where one exists, and ms/img of the slice.

A failing phase raises and the script exits non-zero. The line before
the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.
"""

from __future__ import annotations

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
    return smi


def phase_build():
    from attentionshift_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    for src, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"[build] {src}: {line.strip()}")
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


def kernel_inputs(dev, gen):
    """Each kernel's inputs at the bench shapes (seeded)."""
    import torch

    shape = (1, HEADS, T_PAD, HEAD_DIM)
    qkv = tuple(torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
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
    return dict(qkv=qkv, masks=masks, prot0=prot0, mask=mask, f=f)


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

    out2 = attention.attention_no_capture(q, k, v, PAD_GAP)
    sync()
    e2 = max_err(out2, ref_out)
    expect("attention_plain.out", e2, out_tol, why_out)
    results["attention_plain"] = dict(max_abs_err=e2)

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


def phase_main_path(dev):
    """seed_pseudo_gt at the bench geometry; launch counts of that run."""
    import torch

    from attentionshift_torch.ops._build import KERNELS, reset_launches

    model = build_model(dev, torch.bfloat16)
    inp = slice_inputs(H_IMG, W_IMG, MAX_GT, N_VALID, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    reset_launches()
    out = model.seed_pseudo_gt(*inp, generator=gen)
    sync()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"[main] launches per image: {launches}")
    want = {"attention_capture": CAM_LAYERS, "attention_plain": 12 - CAM_LAYERS,
            "ccl_batch": 1, "meanshift_fixpoint": 1}
    if launches != want:
        raise AssertionError(f"main path launches {launches} != {want}")
    check_outputs(out, H_IMG, W_IMG, MAX_GT, N_VALID)
    nvalid_parts = int(out["semantic_centers_valid"].sum())
    log(f"[main] outputs ok: boxes {out['pseudo_gt_bboxes'][0, :N_VALID].tolist()}, "
        f"valid semantic centers {nvalid_parts}, loss_mil {float(out['loss_mil']):.4f}")
    return model, inp, gen, launches


def phase_times(results: dict, inp: dict, model, slice_inp, gen):
    """CUDA-event times of every kernel, its plain version and the library
    call; bounds from the bytes and operations of these inputs."""
    import torch
    import torch.nn.functional as F

    from attentionshift_torch.ops import attention, ccl, meanshift_kernel

    q, k, v = inp["qkv"]
    b, h, t, d = q.shape
    qkv_bytes = 3 * q.numel() * 2
    attn_flops = 4.0 * b * h * t * t * d
    bias = torch.zeros((1, 1, 1, t), device=q.device, dtype=q.dtype)
    bias[..., PAD_GAP[0]:PAD_GAP[1]] = float("-inf")
    times = {
        "attention_capture": dict(
            ms=cuda_time(lambda: attention.attention_with_capture(q, k, v, PAD_GAP)),
            plain_ms=cuda_time(lambda: attention.attention_reference(q, k, v, PAD_GAP), reps=3),
            library_ms=None,
            bytes=qkv_bytes + q.numel() * 2 + b * t * t * 2, ops=attn_flops, peak=PEAK_BF16),
        "attention_plain": dict(
            ms=cuda_time(lambda: attention.attention_no_capture(q, k, v, PAD_GAP)),
            plain_ms=cuda_time(lambda: attention.attention_reference(q, k, v, PAD_GAP)[0], reps=3),
            library_ms=cuda_time(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)),
            bytes=qkv_bytes + q.numel() * 2, ops=attn_flops, peak=PEAK_BF16),
    }
    masks = inp["masks"]
    # the sweeps each plane runs to its fixpoint: the data-dependent work
    sweeps = ccl.connected_components(masks, 64, return_sweeps=True)[1].tolist()
    cells = masks.shape[1] * masks.shape[2]
    # per sweep and cell: 9-cell minimum + 2 run scans x 2 directions (int32)
    times["ccl_batch"] = dict(
        ms=cuda_time(lambda: ccl.connected_components_batch(masks, 64)),
        plain_ms=cuda_time(lambda: ccl.connected_components(masks, 64), reps=2, warmup=1),
        library_ms=None, bytes=masks.numel() * (1 + 4), ops=float(sum(sweeps)) * cells * 13,
        peak=PEAK_F32)
    log(f"[time] ccl sweeps per plane: max {max(sweeps)}, total {sum(sweeps)} over {len(sweeps)} planes")
    prot0, mask, f = inp["prot0"], inp["mask"], inp["f"]
    g, kk, dd = prot0.shape
    n = f.shape[0]
    times["meanshift_fixpoint"] = dict(
        ms=cuda_time(lambda: meanshift_kernel.cosine_shift_fixpoint(
            prot0, mask, f, n_shift=10, matmul_dtype=torch.bfloat16), reps=5),
        plain_ms=cuda_time(lambda: meanshift_kernel.cosine_shift_batch(
            prot0, f[None] * mask[..., None], f, n_shift=10, matmul_dtype=torch.bfloat16), reps=3),
        library_ms=None,
        bytes=4 * (prot0.numel() + mask.numel() + f.numel() + prot0.numel() + g * kk * n),
        ops=g * (11 * 2.0 * kk * n * dd + 10 * 2.0 * n * dd), peak=PEAK_BF16)
    for name, tm in times.items():
        t_bytes = tm["bytes"] / PEAK_BYTES * 1e3
        t_ops = tm["ops"] / tm["peak"] * 1e3
        results[name].update(
            ms=tm["ms"], plain_ms=tm["plain_ms"], library_ms=tm["library_ms"],
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[time] {name}: kernel {tm['ms']:.4f} ms, plain {tm['plain_ms']:.4f} ms, library "
            f"{tm['library_ms'] if tm['library_ms'] is None else round(tm['library_ms'], 4)} ms, "
            f"bound {results[name]['bound_ms']:.4f} ms ({results[name]['bound_by']})")

    def run():
        model.seed_pseudo_gt(*slice_inp, generator=gen)

    run()
    sync()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    sync()
    ms_img = (time.perf_counter() - t0) / reps * 1e3
    log(f"[time] seed_pseudo_gt at {H_IMG}x{W_IMG}, bf16, ViT-S: {ms_img:.2f} ms/img "
        f"(host clock over {reps} calls ending in synchronize)")
    profile_slice(run, ms_img)
    return ms_img


def profile_slice(run, ms_img: float, top: int = 12) -> None:
    """Where one call's time goes: device time by kernel (torch.profiler)
    and the device's busy share of the call's wall time."""
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
    log(f"[profile] one call: wall {wall_ms:.2f} ms (unprofiled {ms_img:.2f}), device busy "
        f"{dev_ms:.2f} ms = {dev_ms / wall_ms:.1%} of wall, {len(events)} kernel names")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[profile]   device {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:top]:
        log(f"[profile]   host   {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    sys.path.insert(0, HERE)
    if not os.path.isdir(os.path.join(HERE, "attentionshift_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    import torch

    from attentionshift_torch.ops._build import KERNELS

    smi = phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    phase_build()
    results: dict = {}
    inp = kernel_inputs(dev, torch.Generator(device=dev).manual_seed(0))
    phase_kernels(results, inp)
    phase_small_reference(dev)
    model, slice_inp, gen, launches = phase_main_path(dev)
    phase_times(results, inp, model, slice_inp, gen)
    table = []
    for name, kern in KERNELS.items():
        r = results[name]
        table.append(dict(name=name, route="cuda", source=f"attentionshift_torch/csrc/{kern.source}.cu",
                          replaces=kern.replaces, launches=launches[name],
                          max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                          bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                          library_ms=r["library_ms"]))
    log(smi)
    log(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
