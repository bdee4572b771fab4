"""Convert Pascal VOC / SBD instance masks to point-annotated COCO json:
the port's twin of ``tools/dataset_converters/pascal_voc.py``.

    python -m attentionshift_torch.tools.dataset_converters.pascal_voc \\
        --voc-root /data/VOCdevkit/VOC2012 --split train \\
        --out gt_center_train2012.json [--sbd-root /data/SBD --sbd-split train] [--no-rle]

The training entry point reads a COCO-style json whose annotations carry
a per-instance ``point`` (``data/voc.py::VOCPointDataset``). The recipe
synthesises that supervision from the GT masks: instance masks from
SegmentationObject / SegmentationClass (or SBD ``.mat`` files), boxes as
the mask extents, the point as the box centre. Masks are RLE-encoded
with the port's native toolkit (``native/``), so the json also serves
the Mask R-CNN refinement stage. The output is the JAX tool's, key for
key and byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from PIL import Image

from ...data.sbd import image_wise_to_instance_wise
from ...data.voc import VOC_CLASSES
from ...native import rle_encode, rle_to_string


def _mask_anns(masks: np.ndarray, labels: np.ndarray, img_id, start_ann_id: int,
               with_rle: bool):
    anns = []
    for m, lbl in zip(masks, labels):
        ys, xs = np.nonzero(m)
        if len(xs) == 0:
            continue
        x1, x2 = float(xs.min()), float(xs.max()) + 1.0
        y1, y2 = float(ys.min()), float(ys.max()) + 1.0
        ann = dict(
            id=start_ann_id + len(anns),
            image_id=img_id,
            category_id=int(lbl) + 1,  # json categories are 1-based
            bbox=[x1, y1, x2 - x1, y2 - y1],
            area=float(m.sum()),
            iscrowd=0,
            # the point supervision: the mask box's centre
            point=[(x1 + x2) / 2.0, (y1 + y2) / 2.0],
        )
        if with_rle:
            r = rle_encode(np.asarray(m, np.uint8))
            ann["segmentation"] = dict(size=r["size"], counts=rle_to_string(r).decode("ascii"))
        anns.append(ann)
    return anns


def _voc_instances(voc_root: str, vid: str):
    obj = np.asarray(Image.open(os.path.join(voc_root, "SegmentationObject", vid + ".png")),
                     np.int32)
    cls = np.asarray(Image.open(os.path.join(voc_root, "SegmentationClass", vid + ".png")),
                     np.int32)
    # VOC palette pngs: 0 background, 255 ignore border
    obj = np.where(obj == 255, -1, obj)
    cls = np.where(cls == 255, -1, cls)
    return image_wise_to_instance_wise(cls, obj)


def _sbd_instances(sbd_root: str, vid: str):
    from scipy.io import loadmat

    cls = loadmat(os.path.join(sbd_root, "cls", vid + ".mat"))["GTcls"][
        "Segmentation"][0, 0].astype(np.int32)
    inst = loadmat(os.path.join(sbd_root, "inst", vid + ".mat"))["GTinst"][
        "Segmentation"][0, 0].astype(np.int32)
    return image_wise_to_instance_wise(cls, inst)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Convert VOC / SBD masks to point-annotated json.")
    ap.add_argument("--voc-root", required=True, help="VOCdevkit/VOC2012")
    ap.add_argument("--split", default="train", help="ImageSets/Segmentation/<split>.txt")
    ap.add_argument("--sbd-root", default=None,
                    help="optional SBD root (cls/ inst/ img/) for the aug set")
    ap.add_argument("--sbd-split", default="train", help="SBD split file name")
    ap.add_argument("--out", required=True)
    ap.add_argument("--no-rle", action="store_true",
                    help="omit RLE segmentations (points/boxes only)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the converter on ``argv``; returns the json it wrote."""
    args = parse_args(argv)
    images, annotations = [], []
    seen = set()

    def add(vid, img_path, masks, labels):
        if vid in seen or len(masks) == 0:
            return
        seen.add(vid)
        with Image.open(img_path) as im:
            w, h = im.size
        img_id = len(images) + 1
        images.append(dict(id=img_id, file_name=os.path.basename(img_path), width=w, height=h))
        annotations.extend(_mask_anns(masks, labels, img_id, len(annotations) + 1,
                                      with_rle=not args.no_rle))

    split_file = os.path.join(args.voc_root, "ImageSets", "Segmentation", args.split + ".txt")
    with open(split_file) as f:
        voc_ids = [line.strip() for line in f if line.strip()]
    for vid in voc_ids:
        masks, labels = _voc_instances(args.voc_root, vid)
        add(vid, os.path.join(args.voc_root, "JPEGImages", vid + ".jpg"), masks, labels)

    if args.sbd_root:
        with open(os.path.join(args.sbd_root, args.sbd_split + ".txt")) as f:
            sbd_ids = [line.strip() for line in f if line.strip()]
        for vid in sbd_ids:
            masks, labels = _sbd_instances(args.sbd_root, vid)
            add(vid, os.path.join(args.sbd_root, "img", vid + ".jpg"), masks, labels)

    out = dict(images=images, annotations=annotations,
               categories=[dict(id=i + 1, name=n) for i, n in enumerate(VOC_CLASSES)])
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"wrote {args.out}: {len(images)} images, {len(annotations)} instances")
    return out


if __name__ == "__main__":
    main()
