"""Stage-level timing of the pseudo-label pipeline. The port's twin of
``tools/analysis/profile_seed.py``.

    python -m attentionshift_torch.tools.analysis.profile_seed [--height 800] \\
        [--width 1344] [--max-gt 20] [--steps 10] [--dtype bfloat16] [--device cpu]

Times (1) the backbone forward, (2) the backbone + Stage A (rollout,
Hungarian match, CAM -> CCL -> boxes, MIL), (3) the full
``seed_pseudo_gt``, at the benchmark shape, and prints a per-stage
breakdown: Stage A is (2) - (1), Stages B+C are (3) - (2). The model is
the JAX tool's: ViT-S (384 wide, 12 blocks, 6 heads, 100 point tokens, 7
captured layers) with the token axis padded to a multiple of 128, no
activation checkpointing, seeded weights (``init_weights(0)``). Stage A
is ``AttnShiftDetector._extract`` + ``_stage_a``, the part of
``seed_pseudo_gt`` before Stages B+C.

Each call is timed as in the JAX tool: one call outside the clock, then
``--steps`` calls between two synchronisations of the device. The full
call draws from a ``torch.Generator`` seeded 5 on every call, as the JAX
tool hands every call the key 5. The tool runs on the card unless
``--device cpu`` asks for the plain PyTorch path; the attention kernels
take bfloat16 only, so ``--dtype float32`` needs ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np

from .profiling import bench, line

WIDTH = 28
LABELS = ("backbone forward", "backbone + stage A", "full seed_pseudo_gt",
          "stage A (rollout/CCL/MIL)", "stages B+C (refine/shift)")


def build_model(args, device):
    import torch

    from ...models import AttnShiftDetector

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    return AttnShiftDetector(
        num_classes=20, embed_dim=384, depth=12, num_heads=6, img_size=224, point_tokens=100,
        cam_layer=7, max_gt=args.max_gt, use_remat=False, pad_tokens_to=128, dtype=dtype,
        device=device,
    ).init_weights(0)


def make_inputs(h: int, w: int, g: int, device):
    """The JAX tool's seeded batch of one: image, points, labels, validity
    (the first 8 annotations), true (w, h)."""
    import torch

    img = np.random.RandomState(0).randn(1, h, w, 3).astype(np.float32)
    pts = (np.random.RandomState(1).rand(1, g, 2) * [w * 0.9, h * 0.9] + 10).astype(np.float32)
    lbl = np.random.RandomState(2).randint(0, 20, (1, g)).astype(np.int32)
    valid = np.asarray([[True] * 8 + [False] * (g - 8)])
    wh = np.asarray([[float(w), float(h)]], np.float32)
    return [torch.from_numpy(a).to(device) for a in (img, pts, lbl, valid, wh)]


def stage_a(model, img, pts, lbl, valid, wh) -> dict:
    """Backbone + Stage A up to the pseudo boxes."""
    b, h, w, _ = img.shape
    out, roi_map, patch_hw = model._extract(img)
    return model._stage_a(out, roi_map, patch_hw, (h, w), pts, lbl, valid, wh)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Stage-level timing of seed_pseudo_gt.")
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1344)
    ap.add_argument("--max-gt", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the times by label (ms) and the last outputs
    of the three timed calls."""
    import torch

    from ...device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and args.dtype != "bfloat16":
        raise ValueError("--dtype float32: the attention kernels take bfloat16; the plain "
                         "PyTorch path runs with --device cpu")
    model = build_model(args, device)
    img, pts, lbl, valid, wh = make_inputs(args.height, args.width, args.max_gt, device)

    def full():
        gen = torch.Generator(device=device).manual_seed(5)
        return model.seed_pseudo_gt(img, pts, lbl, valid, wh, generator=gen)

    times, outs = {}, {}
    with torch.no_grad():
        for label, fn in zip(LABELS, (lambda: model.backbone_forward(img),
                                      lambda: stage_a(model, img, pts, lbl, valid, wh), full)):
            times[label], outs[label] = bench(fn, args.steps, device)
            print(line(label, times[label], WIDTH), flush=True)
    times[LABELS[3]] = times[LABELS[1]] - times[LABELS[0]]
    times[LABELS[4]] = times[LABELS[2]] - times[LABELS[1]]
    for label in LABELS[3:]:
        print(line(label, times[label], WIDTH), flush=True)
    return dict(times=times, outputs=outs)


if __name__ == "__main__":
    main()
