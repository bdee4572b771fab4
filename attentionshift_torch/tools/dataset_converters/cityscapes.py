"""Convert Cityscapes gtFine annotations to COCO-style instance json: the
port's twin of ``tools/dataset_converters/cityscapes.py``.

    python -m attentionshift_torch.tools.dataset_converters.cityscapes /data/cityscapes \\
        [--img-dir leftImg8bit] [--gt-dir gtFine] [-o outdir]

Walks ``leftImg8bit/<split>/<city>/*_leftImg8bit.png``, reads the paired
``gtFine_instanceIds.png`` and writes one json per split with RLE-encoded
instance masks:

- instance ids >= 1000 encode ``label_id * 1000 + instance``; ids in
  [24, 1000) are crowd regions of that label id (``iscrowd=1``),
- only the eight Cityscapes classes with instances and not ignored in
  eval are kept (person..bicycle), with ``category_id`` = the raw
  Cityscapes label id,
- ``file_name`` keeps the ``<city>/<basename>`` form, ``segm_file``
  points at the labelIds map.

A split without an image directory is skipped with a message; the
splits before it are written. Masks encode through the port's native
RLE toolkit and images load with PIL.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
from PIL import Image

from ...native import rle_encode, rle_to_string

# id -> name for hasInstances and not ignoreInEval; caravan (29) and
# trailer (30) have instances but are ignored in eval
INSTANCE_CLASSES = {
    24: "person",
    25: "rider",
    26: "car",
    27: "truck",
    28: "bus",
    31: "train",
    32: "motorcycle",
    33: "bicycle",
}

SUFFIX = "leftImg8bit.png"


def collect_files(img_dir: str, gt_dir: str):
    files = []
    for img_file in sorted(glob.glob(os.path.join(img_dir, "**", "*.png"), recursive=True)):
        if not img_file.endswith(SUFFIX):
            raise ValueError(f"unexpected image name: {img_file}")
        stem = img_file[len(img_dir):-len(SUFFIX)]
        files.append((img_file, gt_dir + stem + "gtFine_instanceIds.png",
                      gt_dir + stem + "gtFine_labelIds.png"))
    if not files:
        raise FileNotFoundError(f"no images under {img_dir}")
    print(f"loaded {len(files)} images from {img_dir}")
    return files


def load_img_info(img_file: str, inst_file: str, segm_file: str) -> dict:
    inst_img = np.asarray(Image.open(inst_file))
    anno_info = []
    for inst_id in np.unique(inst_img[inst_img >= 24]):
        label_id = int(inst_id) // 1000 if inst_id >= 1000 else int(inst_id)
        if label_id not in INSTANCE_CLASSES:
            continue
        mask = (inst_img == inst_id).astype(np.uint8)
        rle = rle_encode(mask)
        ys, xs = np.nonzero(mask)
        x0, y0 = float(xs.min()), float(ys.min())
        anno_info.append(dict(
            iscrowd=int(inst_id < 1000),
            category_id=label_id,
            bbox=[x0, y0, float(xs.max()) - x0 + 1, float(ys.max()) - y0 + 1],
            area=float(mask.sum()),
            segmentation=dict(size=[int(mask.shape[0]), int(mask.shape[1])],
                              counts=rle_to_string(rle).decode()),
        ))
    city = os.path.basename(os.path.dirname(img_file))
    return dict(
        file_name=os.path.join(city, os.path.basename(img_file)),
        height=int(inst_img.shape[0]),
        width=int(inst_img.shape[1]),
        anno_info=anno_info,
        segm_file=os.path.join(city, os.path.basename(segm_file)),
    )


def cvt_annotations(image_infos: list[dict], out_json_name: str) -> dict:
    out = dict(images=[], categories=[], annotations=[])
    ann_id = 0
    for img_id, info in enumerate(image_infos):
        info = dict(info, id=img_id)
        annos = info.pop("anno_info")
        out["images"].append(info)
        for anno in annos:
            out["annotations"].append(dict(anno, image_id=img_id, id=ann_id))
            ann_id += 1
    out["categories"] = [dict(id=i, name=n) for i, n in sorted(INSTANCE_CLASSES.items())]
    if not out["annotations"]:
        out.pop("annotations")
    with open(out_json_name, "w") as f:
        json.dump(out, f)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Convert Cityscapes annotations to COCO format")
    ap.add_argument("cityscapes_path")
    ap.add_argument("--img-dir", default="leftImg8bit")
    ap.add_argument("--gt-dir", default="gtFine")
    ap.add_argument("-o", "--out-dir", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    out_dir = args.out_dir or args.cityscapes_path
    os.makedirs(out_dir, exist_ok=True)
    img_dir = os.path.join(args.cityscapes_path, args.img_dir)
    gt_dir = os.path.join(args.cityscapes_path, args.gt_dir)
    set_name = dict(
        train="instancesonly_filtered_gtFine_train.json",
        val="instancesonly_filtered_gtFine_val.json",
        test="instancesonly_filtered_gtFine_test.json",
    )
    for split, json_name in set_name.items():
        split_dir = os.path.join(img_dir, split)
        if not os.path.isdir(split_dir):
            print(f"skipping {split}: no {split_dir}")
            continue
        print(f"converting {split} -> {json_name}")
        files = collect_files(split_dir, os.path.join(gt_dir, split))
        infos = [load_img_info(*f) for f in files]
        cvt_annotations(infos, os.path.join(out_dir, json_name))


if __name__ == "__main__":
    main()
