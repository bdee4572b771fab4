"""Evaluation CLI: the port's twin of ``tools/test.py``.

    python -m attentionshift_torch.tools.test CFG [CKPT] [--aug-test] [--limit N] \\
        [--out F] [--dump-preds P] [--gather-dir D] [--cfg-options a.b=v ...] [--device cpu]

Builds the detector of ``CFG``'s ``model`` block, restores ``CKPT`` (a
``train.save_checkpoint`` file or a ``train.save_params`` export; without
one every parameter and buffer is zero, as in the JAX CLI), runs
single-scale inference over ``data.val`` at ``data.test_scale`` or, with
``--aug-test``, the reference protocol of 6 scales x flip, pastes masks
into the original frames and prints the metric dict as JSON on the last
line: VOC07 mask AP at IoU {0.25, 0.5, 0.75} (``mAP@...``) for VOC,
AP/AP50/AP75 for COCO.

``model_type = "mask_rcnn"`` (``configs/mrcnn_refine_voc.py``) builds the
refinement stage's ResNet-FPN ``MaskRCNN``, which both protocols drive
through the same stage contract.

The model runs on the card (the AttnShift detector in bf16, the storage
type of the attention kernels; the Mask R-CNN in f32, as the JAX package
runs it) unless ``--device cpu`` asks for the plain PyTorch path (f32).
Under ``torchrun`` (a process group of N ranks) each rank evaluates its
stride of the dataset and rank 0 merges the predictions through
``--gather-dir``, a directory every rank can write, then computes and
prints the metric; the other ranks print none.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.distributed as dist

# the reference protocol: 6 scales x flip (voc_instance_aug.py:39-53)
AUG_SCALES = [(800, 1333), (600, 1333), (400, 1333), (800, 1000), (600, 1000), (400, 1000)]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a checkpoint (mask AP) with the port.")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--eval", default="mAP_Segm")
    p.add_argument("--limit", type=int, default=None, help="eval first N images")
    p.add_argument("--aug-test", action="store_true",
                   help="multi-scale + flip augmented inference (6 scales x2)")
    p.add_argument("--out", default=None, help="dump raw results json")
    p.add_argument("--dump-preds", default=None, metavar="PKL",
                   help="dump per-image predictions + gts for offline re-evaluation")
    p.add_argument("--gather-dir", default=None,
                   help="shared-FS dir for the multi-process gather (needed with N > 1 ranks)")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(cfg, model, dataset, aug_tester or None) of parsed ``args``; joins
    the process group that ``torchrun`` describes, if any."""
    from ..config import Config
    from ..data.build import build_eval_dataset
    from ..device import resolve_device
    from ..eval.aug_test import AugTester
    from ..models import AttnShiftDetector
    from ..models.mask_rcnn import MaskRCNN
    from ..parallel.mesh import init_distributed
    from ..train.checkpoint import restore_params

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    _, _, dev = init_distributed(resolve_device(args.device))
    if cfg.get("model_type", "attnshift") == "mask_rcnn":
        model = MaskRCNN(device=dev, **cfg.model.to_dict())
    else:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        model = AttnShiftDetector(device=dev, dtype=dtype, **cfg.model.to_dict())
    if args.checkpoint:
        # params-only restore: independent of the training optimizer layout
        model.load_state_dict(restore_params(args.checkpoint), strict=True)
        print(f"loaded {args.checkpoint}")
    else:
        with torch.no_grad():
            for t in model.state_dict().values():
                t.zero_()
    dataset = build_eval_dataset(cfg.data.val.to_dict())
    aug_tester = AugTester(model, scales=AUG_SCALES, flip=True) if args.aug_test else None
    return cfg, model, dataset, aug_tester


def main(argv=None) -> dict | None:
    """Run the CLI on ``argv``; returns the metric dict it printed (None on
    a rank other than 0). A process group that this call created is
    destroyed before it returns."""
    args = parse_args(argv)
    had_group = dist.is_available() and dist.is_initialized()
    try:
        return _run(args)
    finally:
        if not had_group and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _run(args) -> dict | None:
    from ..eval.runner import evaluate

    cfg, model, dataset, aug_tester = build(args)
    grouped = dist.is_available() and dist.is_initialized()
    results = evaluate(
        model, dataset, test_scale=tuple(cfg.data.test_scale), limit=args.limit,
        aug_tester=aug_tester, num_classes=int(cfg.model.num_classes),
        process_index=dist.get_rank() if grouped else 0,
        process_count=dist.get_world_size() if grouped else 1, gather_dir=args.gather_dir,
        dump_path=args.dump_preds,
    )
    if results is None:  # a rank other than 0 of a multi-process eval
        return None
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
