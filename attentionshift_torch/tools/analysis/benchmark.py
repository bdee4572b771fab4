"""End-to-end inference FPS harness: the port's twin of
``tools/analysis/benchmark.py``.

Measures ``simple_test`` (backbone -> RPN -> box head -> NMS -> mask head)
per image at a fixed test shape: ``--warmup`` calls, each synchronised,
then ``--steps`` calls timed on the host clock up to one synchronise.

    python -m attentionshift_torch.tools.analysis.benchmark [CONFIG] \\
        [--height 608 --width 1024] [--batch 1] [--steps 20] [--warmup 3] \\
        [--dtype bfloat16|float32] [--device cpu]

Without a config the model is the JAX tool's default, the ViT-S of
``configs/attnshift_voc12aug.py``; the weights are ``init_weights(0)``'s.
Prints one JSON line (``inference_fps``, ``latency_ms``, ``shape``) with
the device it ran on. The model runs on the card unless ``--device cpu``
asks for the plain PyTorch path; the attention kernels take bf16 only, so
``--dtype float32`` is for the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="simple_test images per second.")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the harness on ``argv``; returns the JSON record it printed."""
    import torch

    from ...device import resolve_device
    from ...models import AttnShiftDetector

    args = parse_args(argv)
    dev = resolve_device(args.device)
    kw = dict(num_classes=20, embed_dim=384, depth=12, num_heads=6, img_size=224,
              point_tokens=100, cam_layer=7)
    if args.config:
        from ...config import Config

        kw.update(Config.fromfile(args.config).model.to_dict())
    kw["use_remat"] = False
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = AttnShiftDetector(device=dev, dtype=dtype, **kw).init_weights(0)

    b, h, w = args.batch, args.height, args.width
    img = torch.from_numpy(np.random.RandomState(0).randn(b, h, w, 3).astype(np.float32)).to(dev)
    img_wh = torch.tensor([[float(w), float(h)]], device=dev).repeat(b, 1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        for _ in range(args.warmup):
            model.simple_test(img, img_wh)
            sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            model.simple_test(img, img_wh)
        sync()
        dt = time.perf_counter() - t0
    rec = dict(metric="inference_fps", value=round(args.steps * b / dt, 3), unit="img/s",
               latency_ms=round(dt / args.steps * 1000 / b, 2), shape=[b, h, w],
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
