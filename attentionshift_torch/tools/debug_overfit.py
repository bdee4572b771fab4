"""Overfit sanity check: the port's twin of ``tools/debug_overfit.py``.

    python -m attentionshift_torch.tools.debug_overfit [--device cpu]

Trains the full flagship model (ViT-S, 384 wide, 12 blocks, 6 heads, 100
point tokens, 7 captured layers, bf16, activation checkpointing) on a
tiny synthetic corpus of 8 blob images at 512x512 for ``STEPS`` (60)
steps and asserts that ``loss_total`` and ``loss_point_cls``, averaged
over the last ``WINDOW`` (8) steps, are below their averages over the
first ``WINDOW``. The corpus draws with numpy exactly as the JAX tool
does. The JAX tool hands every step ``PRNGKey(42)``, which its train step
folds with the step count; here step ``it`` draws from
``train.step_generator(41, it)``, the port's twin of
``fold_in(PRNGKey(41 + 1), it)`` (torch cannot replay JAX's streams, so
the two tools' losses differ). The model starts from ``init_weights(0)``
(the JAX modules' init rules), and every lr scale is 1.0
(``layer_decay=1.0``), as the JAX tool gets them from ``model.init`` and
``build_optimizer`` over its whole variables dict.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

H, W, G = 512, 512, 8
STEPS = 60  # train steps
WINDOW = 8  # steps averaged at each end


def make_sample(rng, i):
    """One blob image with its point supervision (the JAX tool's recipe)."""
    img = rng.randn(H, W, 3).astype(np.float32) * 0.1
    pts, lbls = [], []
    for j in range(2):
        cx, cy = rng.randint(100, 412), rng.randint(100, 412)
        r = rng.randint(40, 90)
        yy, xx = np.mgrid[:H, :W]
        blob = ((xx-cx)**2 + (yy-cy)**2) < r*r
        color = np.zeros(3); color[(i+j) % 3] = 2.5
        img[blob] += color
        pts.append([cx, cy]); lbls.append((i+j) % 3)
    g_pts = np.zeros((G,2), np.float32); g_pts[:2] = pts
    g_lbl = np.zeros((G,), np.int32); g_lbl[:2] = lbls
    g_val = np.zeros((G,), bool); g_val[:2] = True
    return img, g_pts, g_lbl, g_val


def build_model(device):
    """The flagship detector of the JAX tool, seeded init (seed 0)."""
    import torch

    from ..models import AttnShiftDetector

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    return AttnShiftDetector(
        num_classes=20, embed_dim=384, depth=12, num_heads=6, img_size=224,
        point_tokens=100, cam_layer=7, max_gt=G, use_remat=True, num_proposals=512,
        rpn_nms_pre=1000, rcnn_samples=256, mask_sample_cap=64, dtype=dtype, device=device,
    ).init_weights(0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Assert that the flagship overfits 8 blob images.")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the check on ``argv``; returns the mean metrics over the first
    and the last ``WINDOW`` steps and the seconds the steps took."""
    import torch

    from ..device import resolve_device
    from ..train import TrainState, build_optimizer, make_train_step, step_generator

    device = resolve_device(parse_args(argv).device)
    model = build_model(device)
    rng = np.random.RandomState(0)
    data = [make_sample(rng, i) for i in range(8)]
    wh = torch.tensor([[512.0, 512.0]], device=device)
    batches = [dict(img_wh=wh, **{k: torch.from_numpy(a[None]).to(device) for k, a in
                                  zip(("img", "gt_points", "gt_labels", "gt_valid"), s)})
               for s in data]
    opt = build_optimizer(model, base_lr=1e-4, layer_decay=1.0, steps_per_epoch=100,
                          accumulate_steps=1, depth=12, warmup_iters=10)
    state = TrainState.create(model, opt)
    step = make_train_step(model)

    hist = []
    t0 = time.time()
    for it in range(STEPS):
        state, m = step(state, batches[it % 8], generator=step_generator(41, it, device))
        if it in (0, 1):
            print(f"step {it} done at {time.time() - t0:.0f}s", flush=True)
        hist.append(m)
    hist = [{k: float(v) for k, v in m.items()} for m in hist]
    dt = time.time() - t0
    first = {k: float(np.mean([h[k] for h in hist[:WINDOW]])) for k in hist[0]}
    last = {k: float(np.mean([h[k] for h in hist[-WINDOW:]])) for k in hist[0]}
    print(f"{STEPS} steps in {dt:.0f}s")
    for k in sorted(first):
        print(f"{k:>16s}: {first[k]:8.3f} -> {last[k]:8.3f}")
    dec = [k for k in first if k.startswith("loss") and last[k] < first[k]]
    print("decreased:", dec)
    if not last["loss_total"] < first["loss_total"]:
        raise AssertionError("total loss did not decrease")
    if not last["loss_point_cls"] < first["loss_point_cls"]:
        raise AssertionError("loss_point_cls did not decrease")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"OK: the model learns on {name}")
    return dict(first=first, last=last, seconds=dt)


if __name__ == "__main__":
    main()
