"""Shared evaluation loop (tools/test.py + the per-epoch EvalHook).

Port of ``attentionshift_tpu/eval/runner.py``. The reference registers an
``EvalHook`` that runs the val metric every epoch during training
(`attnshift_voc12aug.py:250`, `mmdet/core/evaluation/eval_hooks.py`);
both that and the standalone test CLI funnel through ``evaluate``.
``collect_results_fs`` is a copy of the JAX package's (pickle and the
filesystem).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.coco import COCOEvalDataset
from ..data.pipeline import TestPipeline
from ..data.voc import VOC_CLASSES
from ..train.step import make_eval_step
from .coco_eval import coco_segm_eval
from .masks import finalize_detections
from .mean_ap_segm import eval_map_segm

__all__ = ["evaluate", "collect_results_fs"]


def collect_results_fs(
    gather_dir: str,
    process_index: int,
    process_count: int,
    part: dict,
    timeout_s: float = 1800.0,
    started_at: float | None = None,
    clock_skew_s: float = 120.0,
):
    """Filesystem gather of per-process eval shards.

    The reference's ``collect_results_cpu`` (`mmdet/apis/test.py:117-158`):
    every rank pickles its shard to a shared tmpdir, rank 0 polls for all
    parts and merges. Same protocol here, over a directory every rank
    can write. Returns the merged part list on process 0, None on other
    processes.

    Staleness guard (the reference gets this from a fresh per-run
    tempdir, which needs a broadcast we deliberately avoid): rank 0 only
    accepts part files written after ``started_at`` (minus a clock-skew
    allowance), so leftovers from a previous run in the same
    ``gather_dir`` time out loudly instead of merging silently. Rank 0
    deletes all part files after the merge.
    """
    import os
    import pickle

    if started_at is None:
        started_at = time.time()
    os.makedirs(gather_dir, exist_ok=True)
    tmp = os.path.join(gather_dir, f".part_{process_index}.tmp")
    final = os.path.join(gather_dir, f"part_{process_index}.pkl")
    with open(tmp, "wb") as f:
        pickle.dump(part, f)
    os.replace(tmp, final)  # atomic publish
    if process_index != 0:
        return None
    parts = []
    t0 = time.time()
    fresh_after = started_at - clock_skew_s
    for rank in range(process_count):
        path = os.path.join(gather_dir, f"part_{rank}.pkl")
        while True:
            try:
                if os.path.getmtime(path) >= fresh_after:
                    break
            except OSError:
                pass
            if time.time() - t0 > timeout_s:
                raise TimeoutError(f"eval gather: missing/stale {path}")
            time.sleep(1.0)
        with open(path, "rb") as f:
            parts.append(pickle.load(f))
    for rank in range(process_count):
        try:
            os.remove(os.path.join(gather_dir, f"part_{rank}.pkl"))
        except OSError:
            pass
    return parts


def evaluate(
    model,
    dataset,
    test_scale=(600, 1000),
    limit: int | None = None,
    num_classes: int | None = None,
    aug_tester=None,
    verbose: bool = True,
    process_index: int = 0,
    process_count: int = 1,
    gather_dir: str | None = None,
    dump_path: str | None = None,
) -> dict | None:
    """Single-scale (or aug-test) inference + dataset-appropriate metric.

    With ``process_count > 1`` (the ranks of a process group) each runs the
    ``process_index``-strided shard of the dataset (the
    ``multi_gpu_test`` sharding, `mmdet/apis/test.py:69-116`) and
    predictions are merged through ``gather_dir``; only process 0
    computes and returns the metric dict, others return None.

    Returns a dict of metric name -> value (mAP@{.25,.5,.75} for VOC,
    AP/AP50/AP75 for COCO).

    ``model`` owns its parameters (the JAX version takes ``params`` too):
    single-scale inference is ``make_eval_step(model)`` on the model's
    device, ``aug_tester`` an ``AugTester`` of the same model.
    """
    if process_count > 1 and gather_dir is None:
        raise ValueError("multi-process eval needs gather_dir on a shared FS")
    pipeline = TestPipeline(scale=tuple(test_scale))
    is_coco = isinstance(dataset, COCOEvalDataset)
    if num_classes is None:
        num_classes = dataset.num_classes if is_coco else len(VOC_CLASSES)

    run = make_eval_step(model)
    as_np = lambda t: t.cpu().numpy()  # noqa: E731

    n = len(dataset) if limit is None else min(limit, len(dataset))
    my_indices = list(range(n))[process_index::process_count]
    preds = dict(masks=[], labels=[], scores=[])
    gts = dict(masks=[], labels=[], crowd=[])
    t0 = time.time()
    for i in my_indices:
        if aug_tester is not None:
            raw = dataset[i]["img"]
            a = aug_tester(raw)
            res = finalize_detections(
                a["boxes"], a["scores"], a["labels"], a["valid"],
                a["mask_probs"], scale_wh=np.asarray([1.0, 1.0]),
                orig_wh=np.asarray([raw.shape[1], raw.shape[0]]),
            )
        else:
            sample = pipeline(dataset[i])
            dev = model.device
            out = run(
                torch.from_numpy(sample["img"])[None].to(dev),
                torch.from_numpy(sample["img_wh"])[None].to(dev),
            )
            res = finalize_detections(
                as_np(out.dets.boxes[0]), as_np(out.dets.scores[0]),
                as_np(out.dets.labels[0]), as_np(out.dets.valid[0]),
                as_np(out.mask_probs[0]),
                sample["scale_wh"], sample["orig_wh"],
            )
        gt = dataset.gt_instances(i)
        preds["masks"].append(res["masks"])
        preds["labels"].append(res["labels"])
        preds["scores"].append(res["scores"])
        gts["masks"].append(gt["masks"])
        gts["labels"].append(gt["labels"])
        gts["crowd"].append(gt.get("iscrowd", np.zeros(len(gt["labels"]), bool)))
        done = len(preds["labels"])
        if verbose and done % 50 == 0:
            print(f"eval {done}/{len(my_indices)} "
                  f"({done / (time.time() - t0):.2f} img/s)", flush=True)

    if process_count > 1:
        parts = collect_results_fs(
            gather_dir, process_index, process_count,
            dict(indices=my_indices, preds=preds, gts=gts),
            started_at=t0,
        )
        if parts is None:
            return None
        order = []
        preds = dict(masks=[], labels=[], scores=[])
        gts = dict(masks=[], labels=[], crowd=[])
        for part in parts:
            order.extend(part["indices"])
            for k in preds:
                preds[k].extend(part["preds"][k])
            for k in gts:
                gts[k].extend(part["gts"][k])
        rank = np.argsort(order)
        preds = {k: [v[j] for j in rank] for k, v in preds.items()}
        gts = {k: [v[j] for j in rank] for k, v in gts.items()}

    if dump_path:
        # raw per-image predictions + gts, recomputable offline with
        # tools/analysis/eval_metric.py (the reference's eval_metric.py
        # over a results pickle) or inspected with analyze_results.py
        import pickle

        with open(dump_path, "wb") as f:
            pickle.dump(
                dict(preds=preds, gts=gts, is_coco=is_coco,
                     num_classes=num_classes),
                f,
            )

    if is_coco:
        res = coco_segm_eval(
            preds["masks"], preds["labels"], preds["scores"],
            gts["masks"], gts["labels"], num_classes=num_classes,
            gt_iscrowd=gts["crowd"],
        )
        return {k: float(res[k]) for k in ("AP", "AP50", "AP75")}
    results = {}
    for thr in (0.25, 0.5, 0.75):
        mAP, aps, _ = eval_map_segm(
            preds["masks"], preds["labels"], preds["scores"],
            gts["masks"], gts["labels"], num_classes=num_classes,
            iou_thresh=thr,
        )
        results[f"mAP@{thr}"] = mAP
        if verbose:
            print(f"--- IoU {thr} ---  mAP: {mAP * 100:.1f}")
    return results
