"""Sub-stage timing of Stages B+C at the benchmark shape. The port's twin
of ``tools/analysis/profile_stage_bc.py``.

    python -m attentionshift_torch.tools.analysis.profile_stage_bc [--height 800] \\
        [--width 1344] [--max-gt 20] [--dim 384] [--steps 10] [--device cpu]

Times, each alone on the JAX tool's seeded inputs (patch CAMs, f32 patch
features, boxes, points, labels, the first 8 instances valid, drawn in
its order from ``np.random.RandomState(0)``): the resize of the G patch
CAMs to full resolution, ``cosine_similarity_refined_map`` (refine 2,
objectness tau 0.9), ``sample_mask_points`` and ``semantic_centers``
(10 mean-shift iterations, 5 semantic points: one launch of the
mean-shift kernel). The JAX tool hands every call the key 0; here every
call draws from a ``torch.Generator`` seeded 0. The tool runs on the card
unless ``--device cpu`` asks for the plain PyTorch path.
"""

from __future__ import annotations

import argparse

import numpy as np

from .profiling import bench, line

WIDTH = 34
LABELS = ("cams resize patch->full (G maps)", "cosine_similarity_refined_map",
          "sample_mask_points", "semantic_centers")


def make_inputs(args, device) -> dict:
    import torch

    h, w, g, d = args.height, args.width, args.max_gt, args.dim
    hp, wp = h // 16, w // 16
    rng = np.random.RandomState(0)
    out = dict(
        cams_patch=rng.rand(g, hp, wp).astype(np.float32),
        vit_feat=rng.randn(d, hp, wp).astype(np.float32),
        boxes=(rng.rand(g, 4) * [w / 2, h / 2, w / 2, h / 2] + [0, 0, w / 2, h / 2]).astype(np.float32),
        gt_points=(rng.rand(g, 2) * [w, h]).astype(np.float32),
        gt_labels=rng.randint(0, 20, (g,)).astype(np.int32),
        valid=np.asarray([True] * 8 + [False] * (g - 8)),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Sub-stage timing of Stages B+C.")
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1344)
    ap.add_argument("--max-gt", type=int, default=20)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the times by label (ms per call), the inputs
    and each call's output."""
    import torch

    from ...device import resolve_device
    from ...ops.image import resize
    from ...pseudo.meanshift import semantic_centers
    from ...pseudo.refine import cosine_similarity_refined_map, sample_mask_points

    args = parse_args(argv)
    device = resolve_device(args.device)
    inp = make_inputs(args, device)
    boxes, valid = inp["boxes"], inp["valid"]

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    steps = [
        lambda: resize(inp["cams_patch"], (args.height, args.width)),
        lambda: cosine_similarity_refined_map(up, inp["vit_feat"], boxes, inp["gt_points"], valid,
                                              refine_times=2, obj_tau=0.9, generator=gen()),
        lambda: sample_mask_points(maps.map_fg, maps.map_bg, boxes, num_gt=10, pos_thr=0.35,
                                   neg_thr=0.8, corr_size=21, generator=gen()),
        lambda: semantic_centers(maps.map_fg, maps.map_bg, boxes, inp["vit_feat"],
                                 inp["gt_labels"], valid, pos_thr=0.35, n_shift=10,
                                 num_semantic_points=5),
    ]
    times, outs = {}, {}
    with torch.no_grad():
        for label, fn in zip(LABELS, steps):
            times[label], outs[label] = bench(fn, args.steps, device)
            print(line(label, times[label], WIDTH), flush=True)
            up = outs[LABELS[0]]
            maps = outs.get(LABELS[1])
    return dict(times=times, inputs=inp, outputs=outs)


if __name__ == "__main__":
    main()
