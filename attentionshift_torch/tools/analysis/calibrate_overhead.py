"""Dispatch latency and the memory and tensor-core ceilings of the device.
The port's twin of ``tools/analysis/calibrate_overhead.py``.

    python -m attentionshift_torch.tools.analysis.calibrate_overhead [--steps 30] \\
        [--instances 20] [--height 800] [--width 1344] [--tokens 4352] [--dim 384] \\
        [--device cpu]

Times (a) a trivial op on an 8x8 tensor (the cost of one launch and its
dispatch), (b) one pass and one reduction over a Stage-B-sized f32 tensor
(instances x height x width: the memory rate), (c) the Stage-B resize of
the instances' patch maps to full resolution, in f32 and in bf16, and (d)
two bf16 products, tokens^3 and tokens x tokens x dim (the tensor-core
rate), so that a kernel's time can be told from the per-call overhead.
The products accumulate in f32 and are stored in bf16 (the JAX tool
stores f32; the output is 1/4352 of the product's work). Each is timed as
the JAX tool times it: one call outside the clock, then ``--steps`` calls
between two synchronisations. The tool runs on the card unless
``--device cpu`` asks for the host.
"""

from __future__ import annotations

import argparse

import numpy as np

from .profiling import bench, line

WIDTH = 34


def labels(args) -> list:
    n, h, w, t, d = args.instances, args.height, args.width, args.tokens, args.dim
    hp, wp = h // 16, w // 16
    return ["null op (8x8 add)", f"HBM pass ({n}x{h}x{w} fma)", f"HBM reduce ({n}x{h}x{w} max)",
            f"resize {hp}x{wp}->{h}x{w} ({n})", "resize bf16 in/out",
            f"matmul {t}^3 bf16 ({2 * t ** 3 / 1e9:.0f} GF)",
            f"matmul {t}x{t}x{d} ({2 * t * t * d / 1e9:.1f} GF)"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Dispatch latency and device ceilings.")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--instances", type=int, default=20)
    ap.add_argument("--height", type=int, default=800)
    ap.add_argument("--width", type=int, default=1344)
    ap.add_argument("--tokens", type=int, default=4352)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the times by label (ms per call)."""
    import torch

    from ...device import resolve_device
    from ...ops.image import resize

    args = parse_args(argv)
    device = resolve_device(args.device)
    n, h, w = args.instances, args.height, args.width
    rng = np.random.RandomState(0)

    def on(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    x_small = on(rng.randn(8, 8))
    x_big = on(rng.rand(n, h, w))
    x_patch = on(rng.rand(n, h // 16, w // 16))
    x_patch16 = x_patch.to(torch.bfloat16)
    m1 = on(rng.randn(args.tokens, args.tokens), torch.bfloat16)
    m2 = on(rng.randn(args.tokens, args.dim), torch.bfloat16)
    calls = [
        lambda: x_small + 1.0,
        lambda: x_big * 2.0 + 1.0,
        lambda: x_big.amax(dim=(-2, -1)),
        lambda: resize(x_patch, (h, w)),
        lambda: resize(x_patch16, (h, w)).to(torch.bfloat16),
        lambda: torch.matmul(m1, m1),
        lambda: torch.matmul(m1, m2),
    ]
    times = {}
    with torch.no_grad():
        for label, fn in zip(labels(args), calls):
            times[label], _ = bench(fn, args.steps, device)
            print(line(label, times[label], WIDTH, digits=3), flush=True)
    return dict(times=times)


if __name__ == "__main__":
    main()
