"""Op-level timing of the backbone at the benchmark shape. The port's twin
of ``tools/analysis/profile_backbone.py``.

    python -m attentionshift_torch.tools.analysis.profile_backbone [--tokens 4301] \\
        [--heads 6] [--head-dim 64] [--steps 10] [--device cpu]

Splits the ViT-S forward into its device costs, each timed as one loop
over layers:

- the capture attention (``flash_fwd`` + ``attn_mean``), 7 layers chained,
  the head-mean maps summed;
- the plain attention (``flash_fwd``), 5 layers chained;
- the qkv, proj and MLP products, 12 layers (plain ``torch.matmul``, as the
  JAX tool's are plain XLA products).

The inputs are the JAX tool's: q, k, v, x and the four weight matrices
drawn in its order from ``np.random.RandomState(0)``, bf16, at
(1, heads, tokens, head-dim); the benchmark's T = 4301 is odd and has no
pad gap. The tool runs on the card unless ``--device cpu`` asks for the
plain PyTorch path.
"""

from __future__ import annotations

import argparse

import numpy as np

from .profiling import bench, line

WIDTH = 40
LAYERS = (("capture attention x7", 7), ("no-capture attention x5", 5), ("qkv+proj+mlp x12", 12))


def make_inputs(t: int, heads: int, d: int, device) -> dict:
    """q, k, v (1, heads, t, d), x (1, t, heads * d) and the block's four
    weight matrices, in the JAX tool's order of draws, bf16."""
    import torch

    e = heads * d
    rng = np.random.RandomState(0)
    shapes = dict(q=(1, heads, t, d), k=(1, heads, t, d), v=(1, heads, t, d), x=(1, t, e))
    out = {name: rng.randn(*s) for name, s in shapes.items()}
    for name, s in (("w_qkv", (e, 3 * e)), ("w_proj", (e, e)), ("w_fc1", (e, 4 * e)),
                    ("w_fc2", (4 * e, e))):
        out[name] = rng.randn(*s) * 0.02
    return {k: torch.from_numpy(v.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
            for k, v in out.items()}


def capture7(q, k, v):
    from ...ops.attention import attention_with_capture

    acc = q.new_zeros((q.shape[0], q.shape[2], q.shape[2]))
    o = q
    for _ in range(7):
        o, m = attention_with_capture(o, k, v)
        acc = acc + m
    return o, acc


def nocapture5(q, k, v):
    from ...ops.attention import attention_no_capture

    o = q
    for _ in range(5):
        o = attention_no_capture(o, k, v)
    return o


def mlps12(x, w_qkv, w_proj, w_fc1, w_fc2):
    import torch.nn.functional as F

    e = x.shape[-1]
    o = x
    for _ in range(12):
        qkv = o @ w_qkv
        o = qkv[..., :e] @ w_proj
        # jax.nn.gelu's default is the tanh approximation
        o = F.gelu(o @ w_fc1, approximate="tanh") @ w_fc2
    return o


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Op-level timing of the ViT-S backbone.")
    ap.add_argument("--tokens", type=int, default=4301)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the times by label (ms per call), the inputs
    and each loop's output."""
    import torch

    from ...device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    inp = make_inputs(args.tokens, args.heads, args.head_dim, device)
    qkv = (inp["q"], inp["k"], inp["v"])
    calls = (lambda: capture7(*qkv), lambda: nocapture5(*qkv),
             lambda: mlps12(inp["x"], inp["w_qkv"], inp["w_proj"], inp["w_fc1"], inp["w_fc2"]))
    times, outs = {}, {}
    with torch.no_grad():
        for (label, per), fn in zip(LAYERS, calls):
            times[label], outs[label] = bench(fn, args.steps, device)
            print(f"{line(label, times[label], WIDTH)}  ({times[label] / per:6.3f} ms/layer)",
                  flush=True)
    return dict(times=times, inputs=inp, outputs=outs)


if __name__ == "__main__":
    main()
