"""Fast-path vs exact-path fidelity of the pseudo-label engine. The port's
twin of ``tools/analysis/fidelity_study.py``.

    python -m attentionshift_torch.tools.analysis.fidelity_study [--train-steps 60] \\
        [--train-images 8] [--eval-images 8] [--eval-size H W] [--ckpt FILE] \\
        [--out REPORT.md] [--count-cut] [--device cpu]

The defaults approximate three reference semantics: Stage A's CAM ->
CCL -> box extraction on a stride-16 grid (``cam_stride``), Stages B+C's
similarity maps at stride 4 (``seed_map_stride``) and RoIAlign at a fixed
``sampling_ratio`` 2. Each has an exact setting (stride 1, with 256 CCL
sweeps for full-resolution propagation). The study measures the drift
between the two on structured attention: the flagship (ViT-S, 512x512,
``max_gt`` 8) trained ``--train-steps`` steps on the two-lobed blob corpus
(or restored from ``--ckpt``, a ``train.save_params`` file such as
``learning_check --save-ckpt`` writes), then:

1. end-to-end: ``seed_pseudo_gt`` under both configs, each with its own
   draws (key 7);
2. noise floor: the exact config twice (keys 7 and 8);
3. isolated stride: Stage A's boxes from the same rollout rows at cam
   stride 8, 16 and 1, and Stages B+C with the MIL choice, the boxes and
   the full-resolution seed points shared, only the map stride differing;

plus the semantic-center drift on constructed part-structured features
and RoIAlign's sampling-ratio drift on smooth features. The report (the
JAX tool's keys) is printed as JSON; ``--out`` also writes it as
markdown. The JAX tool writes its report over ``FIDELITY.md``; this twin
writes only where ``--out`` says.

Every draw comes from a ``torch.Generator`` seeded where the JAX tool
seeds a key (``generator``). The models run on the card in bf16 (the
attention kernels' storage type; the JAX tool evaluates in f32) unless
``--device cpu`` asks for the plain PyTorch path in f32. ``--count-cut``
also counts, per CCL configuration, the planes that the sweep cap cut
(those whose labels change at one sweep more): one more CCL call per
call, outside the study's own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

H, W, G = 512, 512, 8

BASE = dict(
    num_classes=20, embed_dim=384, depth=12, num_heads=6, img_size=224,
    point_tokens=100, cam_layer=7, max_gt=G, use_remat=True,
    num_proposals=512, rpn_nms_pre=1000, rcnn_samples=256, mask_sample_cap=64,
)

# fast = the shipped defaults; exact = stride-1 reference semantics with the
# CCL sweep budget scaled to full-resolution propagation distances
FAST = dict(cam_stride=16, seed_map_stride=4, ccl_iters=64)
EXACT = dict(cam_stride=1, seed_map_stride=1, ccl_iters=256)


def generator(seed: int, device):
    """The source of one call's draws: where the JAX tool takes
    ``PRNGKey(seed)``, a generator seeded ``seed``."""
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def make_sample(rng, i, h=None, w=None):
    """The study's two-lobed instances (overlapping discs of distinct
    tones), which give the mean-shift engine part structure to find."""
    h = h or H
    w = w or W
    img = rng.randn(h, w, 3).astype(np.float32) * 0.1
    pts, lbls = [], []
    yy, xx = np.mgrid[:h, :w]
    for j in range(2):
        cx, cy = rng.randint(100, w - 100), rng.randint(100, h - 100)
        r = rng.randint(40, 90)
        dx = int(r * 0.8)
        lobe_a = ((xx - cx + dx) ** 2 + (yy - cy) ** 2) < r * r
        lobe_b = ((xx - cx - dx) ** 2 + (yy - cy) ** 2) < (0.8 * r) ** 2
        color = np.zeros(3)
        color[(i + j) % 3] = 2.5
        img[lobe_a] += color
        img[lobe_b] += np.roll(color, 1) * 0.8 + color * 0.4
        pts.append([cx, cy])
        lbls.append((i + j) % 3)
    g_pts = np.zeros((G, 2), np.float32); g_pts[:2] = pts
    g_lbl = np.zeros((G,), np.int32); g_lbl[:2] = lbls
    g_val = np.zeros((G,), bool); g_val[:2] = True
    return img, g_pts, g_lbl, g_val


def model_dtype(device):
    import torch

    return torch.float32 if device.type == "cpu" else torch.bfloat16


def build_model(overrides: dict, device):
    """The study's flagship under one config (``FAST`` or ``EXACT``),
    seeded init (seed 0)."""
    from ...models import AttnShiftDetector

    return AttnShiftDetector(**BASE, **overrides, dtype=model_dtype(device),
                             device=device).init_weights(0)


def on(device, *arrays):
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a)[None]).to(device) for a in arrays]


def train_params(steps: int, n_images: int, device) -> dict:
    """Partially train the flagship (fast config) so that its attention is
    structured; returns its state dict."""
    import torch

    from ...train import TrainState, build_optimizer, make_train_step

    model = build_model(FAST, device)
    rng = np.random.RandomState(0)
    data = [make_sample(rng, i) for i in range(n_images)]
    wh = torch.tensor([[float(W), float(H)]], device=device)
    batches = [dict(zip(("img", "gt_points", "gt_labels", "gt_valid"), on(device, *s)), img_wh=wh)
               for s in data]
    opt = build_optimizer(model, base_lr=1e-4, layer_decay=1.0, steps_per_epoch=100,
                          accumulate_steps=1, depth=12, warmup_iters=10)
    state = TrainState.create(model, opt)
    step = make_train_step(model)
    t0 = time.time()
    m = {"loss_total": float("nan")}
    for it in range(steps):
        state, m = step(state, batches[it % len(batches)], generator=generator(42 + it, device))
    print(f"trained {steps} steps in {time.time() - t0:.0f}s "
          f"(loss_total {float(m['loss_total']):.2f})", flush=True)
    return model.state_dict()


def seed_model(params: dict, overrides: dict, device):
    model = build_model(overrides, device)
    model.load_state_dict(params)
    return model


def run_seed(model, sample, hw, seed: int, method: str = "seed_pseudo_gt") -> dict:
    """``seed_pseudo_gt`` (or ``seed_debug``) on one sample -> numpy."""
    import torch

    h, w = hw
    dev = model.device
    wh = torch.tensor([[float(w), float(h)]], device=dev)
    out = getattr(model, method)(*on(dev, *sample), wh, generator=generator(seed, dev))
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy() for k, v in out.items()}


def box_iou(a, b):
    x1 = np.maximum(a[0], b[0]); y1 = np.maximum(a[1], b[1])
    x2 = np.minimum(a[2], b[2]); y2 = np.minimum(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ar_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    ar_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    return inter / max(ar_a + ar_b - inter, 1e-6)


def center_drift(ca, va, cb, vb):
    """Greedy nearest matching of valid semantic centers, px distances."""
    ca, cb = ca[va], cb[vb]
    if len(ca) == 0 or len(cb) == 0:
        return []
    d = np.linalg.norm(ca[:, None] - cb[None], axis=-1)
    out = []
    for _ in range(min(len(ca), len(cb))):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        out.append(float(d[i, j]))
        d[i, :] = 1e9; d[:, j] = 1e9
    return out


def pct(v, qs=(50, 90, 100)):
    v = np.asarray(v, np.float64)
    if v.size == 0:
        return {f"p{q}": None for q in qs}
    return {f"p{q}": round(float(np.percentile(v, q)), 4) for q in qs}


class Acc:
    """Per-instance comparison accumulator between two seed outputs."""

    def __init__(self):
        self.iou, self.miou, self.drift, self.corr, self.agree = [], [], [], [], []
        self.nctr_a, self.nctr_b = [], []

    def add(self, ra, rb, val):
        for gi in range(G):
            if not val[gi]:
                continue
            self.nctr_a.append(int(ra["semantic_centers_valid"][0, gi].sum()))
            self.nctr_b.append(int(rb["semantic_centers_valid"][0, gi].sum()))
            self.iou.append(box_iou(ra["pseudo_gt_bboxes"][0, gi], rb["pseudo_gt_bboxes"][0, gi]))
            ma = ra["pseudo_gt_masks"][0, gi] > 0.5
            mb = rb["pseudo_gt_masks"][0, gi] > 0.5
            denom = np.maximum((ma | mb).sum(), 1)
            self.miou.append(float((ma & mb).sum() / denom))
            self.agree.append(float(ra["best_attn_idx"][0, gi] == rb["best_attn_idx"][0, gi]))
            self.drift += center_drift(
                ra["semantic_centers"][0, gi], ra["semantic_centers_valid"][0, gi],
                rb["semantic_centers"][0, gi], rb["semantic_centers_valid"][0, gi],
            )
            a = ra["map_cos_fg"][0, gi]
            bm = rb["map_cos_fg"][0, gi]
            s = int(round(bm.shape[0] / a.shape[0]))
            if s > 1:
                bm = bm[::s, ::s]
            a, bm = a.ravel(), bm.ravel()[: a.size]
            if a.std() > 1e-6 and bm.std() > 1e-6:
                self.corr.append(float(np.corrcoef(a, bm)[0, 1]))

    def report(self):
        return dict(
            pseudo_box_iou=pct(self.iou, (10, 50, 90)),
            pseudo_mask_iou=pct(self.miou, (10, 50, 90)),
            mil_layer_agreement=(round(float(np.mean(self.agree)), 4) if self.agree else None),
            semantic_center_drift_px=pct(self.drift, (50, 90, 100)),
            # mean valid semantic centers per instance on each side: at 0 the
            # drift percentiles are null because nothing was there to match
            centers_per_instance=[
                round(float(np.mean(self.nctr_a)), 3) if self.nctr_a else 0.0,
                round(float(np.mean(self.nctr_b)), 3) if self.nctr_b else 0.0,
            ],
            map_fg_correlation=pct(self.corr, (10, 50)),
            n=len(self.iou),
        )


def cut_planes(labels, more) -> int:
    """Planes of (M, H, W) labels that change at one sweep more (``more``):
    the planes the sweep cap cut."""
    return int((labels != more).flatten(1).any(1).sum())


@contextlib.contextmanager
def counting_cut_planes(store: dict):
    """While active, every CCL call of the pseudo-label engine is made
    once more at one sweep more (``cut_planes``). ``store[(plane shape,
    cap)]`` sums (cut planes, planes)."""
    from ...pseudo import engine

    inner = engine.connected_components_batch

    def ccl(masks, max_iters=256, **kw):
        labels = inner(masks, max_iters, **kw)
        key = (tuple(masks.shape[1:]), int(max_iters))
        cut, n = store.get(key, (0, 0))
        store[key] = (cut + cut_planes(labels, inner(masks, max_iters + 1, **kw)),
                      n + masks.shape[0])
        return labels

    engine.connected_components_batch = ccl
    try:
        yield store
    finally:
        engine.connected_components_batch = inner


def isolated_stride(params, images, hw, device):
    """Experiment 3: the deterministic stride drift, every stochastic and
    learned choice shared between the two paths."""
    import torch

    from ...ops.image import resize
    from ...pseudo.cam import norm_attns
    from ...pseudo.engine import candidate_boxes, masks_and_centers
    from ...pseudo.refine import sample_fgbg_points

    h, w = hw
    debug = seed_model(params, EXACT, device)
    layers = BASE["cam_layer"]

    def boxes_at(rows, tok, pts, stride, iters):
        return candidate_boxes(rows, tok, pts, (h // 16, w // 16), (h, w), cam_stride=stride,
                               ccl_iters=iters)[0].cpu().numpy()

    def bc_at(seed, cams, vit_feat, boxes, pts, lbls, val, ms, override):
        return masks_and_centers(cams, vit_feat, boxes, pts, lbls, val, map_stride=ms,
                                 img_hw=(h, w), points_override=override,
                                 generator=generator(seed, device))

    acc_box, acc_box16, acc = [], [], Acc()
    for i, (img, pts, lbl, val) in enumerate(images):
        d = run_seed(debug, (img, pts, lbl, val), hw, 7, method="seed_debug")
        rows = torch.from_numpy(d["rollout_rows"][0]).to(device)  # (L, P, T)
        tok = torch.from_numpy(d["token_of_gt"][0]).to(device)
        gpts = torch.from_numpy(pts).to(device)

        # Stage A: the same rollout rows, only the cam stride differs
        bf = boxes_at(rows, tok, gpts, 8, 64)
        b16 = boxes_at(rows, tok, gpts, 16, 64)
        be = boxes_at(rows, tok, gpts, 1, 256)
        for gi in range(G):
            if val[gi]:
                acc_box += [box_iou(bf[gi, li], be[gi, li]) for li in range(layers)]
                acc_box16 += [box_iou(b16[gi, li], be[gi, li]) for li in range(layers)]

        # Stages B+C: the exact run's MIL choice and boxes, shared full-res
        # seed points
        best_idx = d["best_attn_idx"][0]
        cams_patch = d["cams"][0]  # (L, G, Hp, Wp)
        best_patch = torch.from_numpy(np.stack(
            [cams_patch[best_idx[gi], gi] for gi in range(G)])).to(device)
        boxes = torch.from_numpy(d["pseudo_gt_bboxes"][0]).to(device)
        vit_feat = torch.from_numpy(d["vit_feat"][0]).to(device)
        cams_full = resize(best_patch, (h, w))
        cams_dec = resize(best_patch, (h // 4, w // 4))
        override = sample_fgbg_points(norm_attns(cams_full), gpts, 0.2, 0.1, 20, stride=1,
                                      generator=generator(3, device))
        common = (gpts, torch.from_numpy(lbl).to(device), torch.from_numpy(val).to(device))
        pf = bc_at(5, cams_dec, vit_feat, boxes, *common, 4, override)
        pe = bc_at(5, cams_full, vit_feat, boxes, *common, 1, override)

        def wrap(p):
            return {k: v[None].float().cpu().numpy() if v.is_floating_point() else v[None].cpu().numpy()
                    for k, v in dict(pseudo_gt_bboxes=boxes, pseudo_gt_masks=p.pseudo_masks,
                                     best_attn_idx=torch.from_numpy(best_idx),
                                     semantic_centers=p.centers.coords,
                                     semantic_centers_valid=p.centers.part_valid,
                                     map_cos_fg=p.map_fg).items()}

        acc.add(wrap(pf), wrap(pe), val)
        print(f"isolated image {i} done", flush=True)
    rep = acc.report()
    rep["stage_a_box_iou_all_layers"] = pct(acc_box, (10, 50, 90))
    rep["stage_a_box_iou_stride16"] = pct(acc_box16, (10, 50, 90))
    return rep, acc


def synthetic_center_drift(hw, device):
    """Stride-4 vs stride-1 semantic-center drift on CONSTRUCTED features.

    Short training on the blob corpus leaves ViT features globally
    correlated, so ``filter_maps``'s 0.85 fg-occupancy gate rejects every
    prototype and the corpus-based drift cells are null. Here part
    structure exists by construction: each instance's box holds two lobes
    with distinct (near-orthogonal) feature directions, so prototypes
    localise, survive the filter, and the stride's effect on the centers
    is measured directly.
    """
    import torch

    from ...pseudo.engine import masks_and_centers

    h, w = hw
    rng = np.random.RandomState(7)
    d, hp, wp = 384, h // 16, w // 16
    drift, nctr, in_fg = [], [], []
    for _trial in range(16):
        base = rng.randn(d).astype(np.float32)
        feat = np.tile(base[:, None, None], (1, hp, wp))
        feat += rng.randn(d, hp, wp).astype(np.float32) * 0.05
        boxes, pts, fg = [], [], np.zeros((G, h, w), np.float32)
        for gi in range(2):
            x1, y1 = rng.randint(16, 200, 2)
            bw, bh = rng.randint(120, 240, 2)
            x2, y2 = min(x1 + bw, w - 1), min(y1 + bh, h - 1)
            boxes.append([x1, y1, x2, y2])
            pts.append([(x1 + x2) / 2, (y1 + y2) / 2])
            for li in range(2):  # two lobes with their own feature directions
                lv = rng.randn(d).astype(np.float32) * 2.0
                lx1 = (x1 + li * (x2 - x1) // 2) // 16
                lx2 = (x1 + (li + 1) * (x2 - x1) // 2) // 16
                feat[:, y1 // 16: y2 // 16, lx1:lx2] = lv[:, None, None] + rng.randn(d, 1, 1) * 0.05
            fg[gi, y1:y2, x1:x2] = 1.0
        boxes = np.pad(np.asarray(boxes, np.float32), ((0, G - 2), (0, 0)))
        pts = np.pad(np.asarray(pts, np.float32), ((0, G - 2), (0, 0)))
        val = np.zeros((G,), bool); val[:2] = True
        lbl = np.zeros((G,), np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        outs = {}
        for ms in (4, 1):
            p = masks_and_centers(t(fg[:, ::ms, ::ms]), t(feat), t(boxes), t(pts), t(lbl), t(val),
                                  map_stride=ms, img_hw=(h, w), generator=generator(11, device))
            outs[ms] = (p.centers.coords.float().cpu().numpy(), p.centers.part_valid.cpu().numpy())
        for gi in range(2):
            nctr.append(int(outs[1][1][gi].sum()))
            drift += center_drift(outs[4][0][gi], outs[4][1][gi], outs[1][0][gi], outs[1][1][gi])
            # px drift overstates harm: what matters is whether a fast-path
            # center still lands on the instance (a tail drift is the two
            # equivalent lobes swapping rank, not a center leaving the object)
            for c, v in zip(*(x[gi] for x in outs[4])):
                if v:
                    xi = int(np.clip(round(c[0]), 0, w - 1))
                    yi = int(np.clip(round(c[1]), 0, h - 1))
                    in_fg.append(float(fg[gi, yi, xi] > 0.5))
    return dict(
        center_drift_px=pct(drift, (50, 90, 100)),
        exact_centers_per_instance=round(float(np.mean(nctr)), 3),
        fast_center_in_fg_frac=(round(float(np.mean(in_fg)), 4) if in_fg else None),
        n_pairs=len(drift),
    )


def roi_align_sr_error(device) -> dict:
    """RoIAlign sampling-ratio drift against sampling ratio 8 on SMOOTH
    (ViT-like) features, relative to the mean |feature|: mean and max."""
    import torch

    from ...ops.image import resize
    from ...ops.roi_align import roi_align

    lowres = np.random.RandomState(1).randn(1, 384, 8, 8).astype(np.float32)
    feat = resize(torch.from_numpy(lowres[0]).to(device), (32, 32))[None]
    boxes = torch.tensor([[0, 10.0, 10.0, 300.0, 200.0], [0, 50.0, 80.0, 120.0, 140.0],
                          [0, 0.0, 0.0, 511.0, 511.0]], device=device)
    outs = {sr: roi_align(feat, boxes, 1.0 / 16.0, output_size=7, sampling_ratio=sr).cpu().numpy()
            for sr in (1, 2, 4, 8)}
    ref8 = outs[8]
    scale = np.abs(ref8).mean() + 1e-9
    return {sr: dict(mean=round(float(np.abs(outs[sr] - ref8).mean() / scale), 5),
                     max=round(float(np.abs(outs[sr] - ref8).max() / scale), 5))
            for sr in (1, 2, 4)}


def markdown(report: dict, hw, provenance: str, device) -> str:
    """The JAX tool's markdown report, produced by this twin."""
    iso, syn, sr_err = (report["isolated_stride"], report["synthetic_feature_center_drift"],
                        report["roi_align_sr_rel_err_vs_sr8"])
    stable = iso.get("pseudo_mask_iou_stable_subset", {})

    def row(name, r):
        return (
            f"| {name} | {r['pseudo_box_iou']['p50']} / {r['pseudo_box_iou']['p10']} | "
            f"{r['pseudo_mask_iou']['p50']} / {r['pseudo_mask_iou']['p10']} | "
            f"{r['mil_layer_agreement']} | "
            f"{r['semantic_center_drift_px']['p50']} / {r['semantic_center_drift_px']['p90']} | "
            f"{r['map_fg_correlation']['p50']} |"
        )

    cut = report.get("ccl_planes_cut")
    md = [
        "# FIDELITY — fast-path vs exact-path pseudo-label drift (PyTorch port)",
        "",
        "Defaults (`cam_stride=16`, `seed_map_stride=4`, RoIAlign `sampling_ratio=2`)",
        "vs exact reference semantics (`cam_stride=1`, `seed_map_stride=1`,",
        "`ccl_iters=256`), measured on a partially-trained flagship ViT-S at",
        f"{hw[0]}x{hw[1]} ({provenance}, trained on the synthetic blob dataset,",
        f"held-out eval draws), on {device} in {report['dtype']}. Produced by",
        "`python -m attentionshift_torch.tools.analysis.fidelity_study`.",
        "",
        "Three comparisons (per-instance distributions):",
        "",
        "- **end-to-end**: both configs run the full `seed_pseudo_gt` with their",
        "  own stochastic seed-point draws — total pipeline variance;",
        "- **noise floor**: the exact config against itself with a different",
        "  sampling seed — how much of the end-to-end drift is sampling",
        "  stochasticity, not stride;",
        "- **isolated stride**: shared rollout rows, MIL choice, boxes, and",
        "  full-res seed points; only the stride differs — the deterministic",
        "  cost of the approximation, which is what gates the defaults.",
        "",
        "| comparison | box IoU p50/p10 | mask IoU p50/p10 | MIL agree | center drift px p50/p90 | map_fg corr p50 |",
        "|---|---|---|---|---|---|",
        row("end-to-end", report["end_to_end"]),
        row("noise floor (exact vs exact)", report["sampling_noise_floor"]),
        row("isolated stride", iso),
        "",
        "Mean valid semantic centers per instance (fast / exact): "
        f"{report['end_to_end']['centers_per_instance'][0]} / "
        f"{report['end_to_end']['centers_per_instance'][1]} — null drift "
        "cells mean no valid centers existed to match.",
        "",
        "Isolated-stride mask IoU on the NOISE-FLOOR-STABLE subset "
        "(instances whose exact-vs-exact IoU >= 0.9): "
        f"p10/p50/p90 = {stable.get('p10')} / {stable.get('p50')} / {stable.get('p90')} "
        f"(n = {iso.get('stable_subset_n')}).",
        "",
        "Semantic-center stride drift on CONSTRUCTED part-structured "
        "features (stride 4 vs 1, shared seeds): "
        f"p50/p90/p100 = {syn['center_drift_px']['p50']} / "
        f"{syn['center_drift_px']['p90']} / {syn['center_drift_px']['p100']} px, "
        f"{syn['exact_centers_per_instance']} centers/instance, "
        f"n = {syn['n_pairs']}; fraction of fast-path centers inside the "
        f"exact fg region = {syn['fast_center_in_fg_frac']}.",
        "",
        f"Stage-A candidate-box IoU across all layers (isolated, stride 8 vs 1): "
        f"p10/p50/p90 = {iso['stage_a_box_iou_all_layers']['p10']} / "
        f"{iso['stage_a_box_iou_all_layers']['p50']} / "
        f"{iso['stage_a_box_iou_all_layers']['p90']}",
        "",
        f"Same at stride 16 vs 1 (the shipped default): "
        f"p10/p50/p90 = {iso['stage_a_box_iou_stride16']['p10']} / "
        f"{iso['stage_a_box_iou_stride16']['p50']} / "
        f"{iso['stage_a_box_iou_stride16']['p90']}",
        "",
        "RoIAlign sampling-ratio drift vs sr=8 on smooth (ViT-like) features,",
        "relative to mean |feature|:",
        "",
        *(f"- sr={sr}: mean {sr_err[sr]['mean']}, max {sr_err[sr]['max']}" for sr in (1, 2, 4)),
        "",
    ]
    if cut is not None:
        md += ["CCL planes cut by the sweep cap (labels that change at one sweep more), "
               "per (plane shape, cap): "
               + "; ".join(f"{k}: {v[0]} of {v[1]}" for k, v in cut.items()), ""]
    md += ["Raw JSON:", "```json", json.dumps(report, indent=2), "```", ""]
    return "\n".join(md)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Fast-path vs exact-path pseudo-label drift.")
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--train-images", type=int, default=8)
    ap.add_argument("--eval-images", type=int, default=8)
    ap.add_argument("--eval-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="evaluate at this resolution instead of the 512x512 training size "
                         "(multiples of 16)")
    ap.add_argument("--ckpt", default=None, metavar="FILE",
                    help="a train.save_params file to study instead of inline training "
                         "(learning_check --save-ckpt writes one)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="also write the report as markdown to PATH")
    ap.add_argument("--count-cut", action="store_true",
                    help="count the CCL planes the sweep cap cut (one more CCL call per call)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the study; returns the report it printed."""
    from ...device import resolve_device
    from ...train import restore_params

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.ckpt:
        params = restore_params(os.path.abspath(args.ckpt))
        provenance = f"checkpoint `{args.ckpt}`"
    else:
        params = train_params(args.train_steps, args.train_images, device)
        provenance = f"{args.train_steps} inline train steps"
    hw = tuple(args.eval_size) if args.eval_size else (H, W)

    cut: dict = {}
    with counting_cut_planes(cut) if args.count_cut else contextlib.nullcontext():
        fast, exact = seed_model(params, FAST, device), seed_model(params, EXACT, device)
        rng = np.random.RandomState(100)  # held-out draws
        images = [make_sample(rng, i, *hw) for i in range(args.eval_images)]
        e2e, floor = Acc(), Acc()
        for i, sample in enumerate(images):
            t0 = time.time()
            rf = run_seed(fast, sample, hw, 7)
            re = run_seed(exact, sample, hw, 7)
            re2 = run_seed(exact, sample, hw, 8)
            e2e.add(rf, re, sample[3])
            floor.add(re, re2, sample[3])
            print(f"image {i}: e2e fast/exact/exact2 in {time.time() - t0:.1f}s", flush=True)
        del fast, exact
        iso, iso_acc = isolated_stride(params, images, hw, device)

    # the isolated stride on the instances that the noise floor calls stable
    # (exact-vs-exact mask IoU >= 0.9); both accumulators walk the same
    # (image, instance) sequence
    if len(floor.miou) == len(iso_acc.miou):
        stable = [i for i, v in enumerate(floor.miou) if v >= 0.9]
        iso["pseudo_mask_iou_stable_subset"] = pct([iso_acc.miou[i] for i in stable], (10, 50, 90))
        iso["stable_subset_n"] = len(stable)

    report = dict(
        params_provenance=provenance,
        train_steps=None if args.ckpt else args.train_steps,
        eval_images=args.eval_images,
        end_to_end=e2e.report(),
        sampling_noise_floor=floor.report(),
        isolated_stride=iso,
        synthetic_feature_center_drift=synthetic_center_drift(hw, device),
        roi_align_sr_rel_err_vs_sr8=roi_align_sr_error(device),
        device=str(device),
        dtype=str(model_dtype(device)).replace("torch.", ""),
    )
    if args.count_cut:
        report["ccl_planes_cut"] = {f"{k[0][0]}x{k[0][1]} cap {k[1]}": list(v)
                                    for k, v in sorted(cut.items())}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(markdown(report, hw, provenance, device))
        print(f"wrote {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main()
