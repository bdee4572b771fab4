"""Sub-stage timing of Stage A at the benchmark shape. The port's twin of
``tools/analysis/profile_stage_a.py``.

    python -m attentionshift_torch.tools.analysis.profile_stage_a [--height 800] \\
        [--width 1344] [--max-gt 20] [--dim 384] [--points 100] [--layers 7] \\
        [--steps 10] [--device cpu]

Splits Stage A into the attention rollout over the captured maps, the
CAM -> CCL -> box candidate extraction (``candidate_boxes`` at cam stride
8 and 64 sweeps: one launch of the CCL kernel) and the MIL RoI
featurisation (``roi_align`` of G * L RoIs), each timed alone on the JAX
tool's seeded inputs: L softmax maps of (T, T) rounded to bf16, the
matched tokens, the points, a bf16 (D, H/16, W/16) feature map and G * L
boxes, drawn in its order from ``np.random.RandomState(0)``. The tool runs
on the card unless ``--device cpu`` asks for the plain PyTorch path.
"""

from __future__ import annotations

import argparse

import numpy as np

from .profiling import bench, line

WIDTH = 34


def labels(args) -> list:
    g, l, t = args.max_gt, args.layers, tokens(args)
    return [f"rollout ({l} bf16 {t}x{t} maps)", "candidate_boxes (CAM/CCL/box)",
            f"MIL roi_align ({g * l} rois)"]


def tokens(args) -> int:
    return 1 + (args.height // 16) * (args.width // 16) + args.points


def make_inputs(args, device) -> dict:
    import torch

    h, w, g, d, p, l = args.height, args.width, args.max_gt, args.dim, args.points, args.layers
    hp, wp, t = h // 16, w // 16, tokens(args)
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(l, 1, t, t).astype(np.float32)).to(device)
    attns = torch.softmax(logits, dim=-1).to(torch.bfloat16)
    del logits
    tok = rng.randint(0, p, (g,)).astype(np.int32)
    pts = (rng.rand(g, 2) * [w, h]).astype(np.float32)
    roi_map = rng.randn(1, d, hp, wp).astype(np.float32)
    cand = (rng.rand(g * l, 4) * [w / 2, h / 2, w / 2, h / 2] + [0, 0, w / 2, h / 2]).astype(np.float32)
    out = dict(attns=attns, tok=torch.from_numpy(tok).to(device),
               gt_points=torch.from_numpy(pts).to(device),
               roi_map=torch.from_numpy(roi_map).to(device=device, dtype=torch.bfloat16))
    out["rois"] = torch.cat([torch.zeros((g * l, 1)), torch.from_numpy(cand)], dim=1).to(device)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Sub-stage timing of Stage A.")
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1344)
    ap.add_argument("--max-gt", type=int, default=20)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--points", type=int, default=100)
    ap.add_argument("--layers", type=int, default=7)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the times by label (ms per call), the inputs
    and each call's output."""
    import torch

    from ...device import resolve_device
    from ...ops.roi_align import roi_align
    from ...pseudo.engine import candidate_boxes
    from ...pseudo.rollout import attention_rollout_point_rows

    args = parse_args(argv)
    device = resolve_device(args.device)
    inp = make_inputs(args, device)
    hw, patch_hw = (args.height, args.width), (args.height // 16, args.width // 16)
    times, outs = {}, {}
    names = labels(args)
    with torch.no_grad():
        times[names[0]], rows = bench(
            lambda: attention_rollout_point_rows(inp["attns"], num_points=args.points),
            args.steps, device)
        times[names[1]], cand = bench(
            lambda: candidate_boxes(rows[:, 0], inp["tok"], inp["gt_points"], patch_hw, hw,
                                    cam_stride=8, ccl_iters=64), args.steps, device)
        times[names[2]], feats = bench(
            lambda: roi_align(inp["roi_map"], inp["rois"], 1.0 / 16, output_size=7),
            args.steps, device)
    for name in names:
        print(line(name, times[name], WIDTH), flush=True)
    outs = dict(zip(names, (rows, cand, feats)))
    return dict(times=times, inputs=inp, outputs=outs)


if __name__ == "__main__":
    main()
