"""The port's copies of the numpy modules against the JAX package's.

``native`` (the RLE mask toolkit, built by the port into its own build
directory), ``data`` (datasets, the train and test pipelines, the train
loader, the corruption suite) and ``config.merge_from_options``: each on
the same inputs, made from a numpy seed, through both packages; every
output exactly equal.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_support import coco_tree, sbd_tree, voc_tree  # noqa: E402

from attentionshift_torch import native  # noqa: E402
from attentionshift_tpu import native as jnative  # noqa: E402


def _same(a, b, what=""):
    """Nested dicts / lists / arrays / scalars exactly equal, dtypes too."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (what, a.dtype, b)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


# ------------------------------------------------------------------ native


def _rand_mask(seed, h=37, w=53):
    from scipy import ndimage

    return ndimage.gaussian_filter(np.random.RandomState(seed).rand(h, w), 3) > 0.5


def test_native_builds_into_the_ports_build_dir():
    """The port builds its own library (never the JAX package's
    ``_maskapi.so``), into ``build/attentionshift_torch`` under a hashed name."""
    import os

    from attentionshift_torch.ops._build import BUILD_DIR

    assert native.native_available() and jnative.native_available()
    so = native._so_path()
    assert os.path.dirname(so) == BUILD_DIR and os.path.basename(so).startswith("maskapi-")
    assert os.path.exists(so)


def _native_cases():
    """(name, fn(module) -> result) of every case of tests/test_native.py."""
    masks_a = [_rand_mask(i) for i in range(3)]
    masks_b = [_rand_mask(i + 10) for i in range(4)]
    corner = np.zeros((3, 3), bool)
    corner[0, 1] = True

    def roundtrip(seed):
        def run(nat):
            rle = nat.rle_encode(_rand_mask(seed))
            return rle, nat.rle_decode(rle), nat.rle_area(rle)
        return run

    def empty_full(nat):
        out = []
        for m in (np.zeros((8, 6), bool), np.ones((8, 6), bool)):
            rle = nat.rle_encode(m)
            out.append((rle, nat.rle_decode(rle), nat.rle_area(rle)))
        return out

    def iou(nat):
        ra = [nat.rle_encode(m) for m in masks_a]
        rb = [nat.rle_encode(m) for m in masks_b]
        return (nat.rle_iou_matrix(ra, rb),
                nat.rle_iou_matrix(ra, rb, iscrowd_b=np.asarray([0, 1, 0, 1], bool)))

    def string(nat):
        rle = nat.rle_encode(_rand_mask(5))
        s = nat.rle_to_string(rle)
        back = nat.rle_from_string(s, rle["size"])
        return s, back, nat.rle_decode(back), nat.rle_from_string(s.decode(), rle["size"])

    return {
        **{f"roundtrip{s}": roundtrip(s) for s in (0, 1, 2)},
        "empty_full": empty_full,
        "iou_matrix": iou,
        "string": string,
        "coco_compat": lambda nat: nat.rle_encode(corner),
        "polygon_square": lambda nat: nat.polygons_to_mask([[2, 2, 8, 2, 8, 8, 2, 8]], 10, 12),
        "polygon_triangle_and_two": lambda nat: (
            nat.polygons_to_mask([[0, 0, 10, 0, 0, 10]], 10, 10),
            nat.polygons_to_mask([[0, 0, 4, 0, 4, 4, 0, 4], [6, 6, 9, 6, 9, 9, 6, 9], [1, 1]],
                                 10, 10)),
    }


@pytest.mark.parametrize("case", list(_native_cases()))
def test_native_matches_jax_package(case):
    """Every case of ``tests/test_native.py`` through both packages:
    exactly equal (RLE dicts, decoded masks, areas, IoU matrices with and
    without crowd columns, strings, rasterised polygons)."""
    fn = _native_cases()[case]
    _same(fn(native), fn(jnative), case)


@pytest.mark.parametrize("case", list(_native_cases()))
def test_native_fallback_matches_native(case, monkeypatch):
    """The port keeps the reference's numpy fallback: without the library
    every case gives what the library gives. The fallback's polygon raster
    is PIL's, which also fills the pixels the outline crosses: it holds the
    library's mask and lies within one pixel of it."""
    fn = _native_cases()[case]
    want = fn(native)
    monkeypatch.setattr(native, "_load", lambda: None)
    got = fn(native)
    if case.startswith("polygon"):
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            from scipy import ndimage

            assert g.shape == w.shape and w.any() and not (w & ~g).any()
            assert not (g & ~ndimage.binary_dilation(w, np.ones((3, 3), bool))).any()
        return
    _same(got, want, case)


# -------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return dict(voc=voc_tree(tmp_path_factory.mktemp("VOC2012")),
                coco=coco_tree(tmp_path_factory.mktemp("coco")),
                sbd=sbd_tree(tmp_path_factory.mktemp("sbd")))


def test_voc_datasets_match_jax_package(trees):
    """``VOCPointDataset`` samples (with ``repeat``) and
    ``VOCInstanceEvalDataset`` images and ``gt_instances`` (palette PNGs,
    255 boundaries): exactly equal, the instances really there."""
    from attentionshift_torch.data.voc import VOC_CLASSES, VOCInstanceEvalDataset, VOCPointDataset
    from attentionshift_tpu.data import voc as jvoc

    t = trees["voc"]
    assert VOC_CLASSES == jvoc.VOC_CLASSES
    a, b = VOCPointDataset(t["ann_file"], t["img_prefix"], repeat=2), \
        jvoc.VOCPointDataset(t["ann_file"], t["img_prefix"], repeat=2)
    assert len(a) == len(b) == 4
    for i in range(len(a)):
        _same(a[i], b[i], f"point sample {i}")
    a, b = (VOCInstanceEvalDataset(t["split_file"], t["voc_root"]),
            jvoc.VOCInstanceEvalDataset(t["split_file"], t["voc_root"]))
    assert len(a) == len(b) == 2
    for i in range(len(a)):
        _same(a[i], b[i], f"eval sample {i}")
        gt = a.gt_instances(i)
        _same(gt, b.gt_instances(i), f"gt {i}")
        assert len(gt["labels"]) == 2 + i % 2


def test_coco_datasets_match_jax_package(trees):
    """``COCOPointDataset`` and ``COCOEvalDataset`` (polygon, RLE string,
    RLE counts, a crowd region, non-contiguous category ids): exactly equal."""
    from attentionshift_torch.data.coco import COCOEvalDataset, COCOPointDataset
    from attentionshift_tpu.data import coco as jcoco

    t = trees["coco"]
    a, b = COCOPointDataset(t["ann_file"], t["img_prefix"]), \
        jcoco.COCOPointDataset(t["ann_file"], t["img_prefix"])
    assert len(a) == len(b) == 2 and a.cat2label == b.cat2label
    for i in range(len(a)):
        _same(a[i], b[i], f"point sample {i}")
    a, b = COCOEvalDataset(t["ann_file"], t["img_prefix"]), \
        jcoco.COCOEvalDataset(t["ann_file"], t["img_prefix"])
    assert a.num_classes == b.num_classes == 5
    crowd = 0
    for i in range(len(a)):
        _same(a[i], b[i], f"eval sample {i}")
        gt = a.gt_instances(i)
        _same(gt, b.gt_instances(i), f"gt {i}")
        assert gt["masks"].sum(axis=(1, 2)).min() > 0
        crowd += int(gt["iscrowd"].sum())
    assert crowd == 1


def test_sbd_dataset_matches_jax_package(trees):
    """``SBDInstanceDataset`` (.mat class and instance maps, box-centre
    points) and ``image_wise_to_instance_wise``: exactly equal."""
    from attentionshift_torch.data.sbd import SBDInstanceDataset, image_wise_to_instance_wise
    from attentionshift_tpu.data import sbd as jsbd

    t = trees["sbd"]
    a, b = SBDInstanceDataset(**t, repeat=2), jsbd.SBDInstanceDataset(**t, repeat=2)
    assert len(a) == len(b) == 4
    for i in range(len(a)):
        _same(a[i], b[i], f"sample {i}")
        _same(a.gt_instances(i), b.gt_instances(i), f"gt {i}")
    rs = np.random.RandomState(3)
    cls = rs.randint(0, 21, (12, 9)).astype(np.int32)
    inst = rs.randint(-1, 4, (12, 9)).astype(np.int32)
    _same(image_wise_to_instance_wise(cls, inst), jsbd.image_wise_to_instance_wise(cls, inst))


def test_build_matches_jax_package(trees, tmp_path):
    """``build_train_dataset`` / ``build_eval_dataset`` dispatch to the same
    datasets, the refinement stage's ``InstanceCocoDataset`` (over the COCO
    tree's polygon and RLE segmentations, with boxes) included."""
    from attentionshift_torch.data import build_eval_dataset, build_train_dataset
    from attentionshift_tpu.data import build_eval_dataset as jeval
    from attentionshift_tpu.data import build_train_dataset as jtrain

    v, c = trees["voc"], trees["coco"]
    coco = json.loads(open(c["ann_file"]).read())
    for i, ann in enumerate(coco["annotations"]):
        ann["bbox"] = [2.0 + i, 3.0, 20.0 + i, 15.0]
    instances = tmp_path / "instances_boxes.json"
    instances.write_text(json.dumps(coco))
    nodes = [
        (build_train_dataset, jtrain, dict(ann_file=v["ann_file"], img_prefix=v["img_prefix"],
                                           repeat=3)),
        (build_train_dataset, jtrain, dict(type="COCOPointDataset", **c)),
        (build_eval_dataset, jeval, dict(split_file=v["split_file"], voc_root=v["voc_root"])),
        (build_eval_dataset, jeval, dict(type="COCOEvalDataset", **c)),
        (build_train_dataset, jtrain, dict(type="InstanceCocoDataset", ann_file=str(instances),
                                           img_prefix=c["img_prefix"], repeat=2)),
    ]
    for mine, ref, node in nodes:
        a, b = mine(node), ref(node)
        assert type(a).__name__ == type(b).__name__ and len(a) == len(b)
        _same(a[len(a) - 1], b[len(b) - 1])
    for fn in (build_train_dataset, build_eval_dataset):
        with pytest.raises(ValueError, match="unknown"):
            fn(dict(type="Nope"))


def _sample(h=200, w=300, seed=0):
    rs = np.random.RandomState(seed)
    return dict(img=(rs.rand(h, w, 3) * 255).astype(np.uint8),
                points=np.asarray([[150.0, 100.0], [290.0, 10.0], [5.0, 190.0]], np.float32),
                labels=np.asarray([1, 2, 7], np.int64), img_id="x")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(scales=((128, 256),), max_gt=4, flip_ratio=1.0),
    dict(scales=((128, 256), (160, 320)), max_gt=2, crop_size=(160, 240), brightness_delta=0.3),
], ids=["default", "flip", "crop_brightness"])
def test_train_pipeline_matches_jax_package(kw):
    """``TrainPipeline`` on the same sample with the same ``RandomState``
    (landscape and portrait images, several draws): exactly equal."""
    from attentionshift_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD, TrainPipeline
    from attentionshift_tpu.data import pipeline as jpipe

    np.testing.assert_array_equal(IMAGENET_MEAN, jpipe.IMAGENET_MEAN)
    np.testing.assert_array_equal(IMAGENET_STD, jpipe.IMAGENET_STD)
    a, b = TrainPipeline(**kw), jpipe.TrainPipeline(**kw)
    assert a.bucket_hw == b.bucket_hw
    for seed, (h, w) in enumerate([(200, 300), (300, 200)]):
        s = _sample(h, w, seed)
        for draw in range(2):
            _same(a(s, np.random.RandomState((seed, draw))), b(s, np.random.RandomState((seed, draw))),
                  f"sample {seed} draw {draw}")


@pytest.mark.parametrize("scale", [(600, 1000), (96, 160)])
def test_test_pipeline_matches_jax_package(scale):
    """``TestPipeline`` (keep-ratio PIL resize, normalise, pad to the
    bucket), landscape and portrait: exactly equal."""
    from attentionshift_torch.data.pipeline import TestPipeline
    from attentionshift_tpu.data.pipeline import TestPipeline as JTestPipeline

    a, b = TestPipeline(scale=scale), JTestPipeline(scale=scale)
    for h, w in ((375, 500), (500, 375)):
        _same(a(_sample(h, w)), b(_sample(h, w)), f"{h}x{w}")


def test_train_loader_matches_jax_package(trees):
    """``TrainLoader``: the same batches in the same order (one worker
    thread), and the same per-host strided shards for 2 processes."""
    from attentionshift_torch.data import TrainLoader, TrainPipeline, VOCPointDataset
    from attentionshift_tpu import data as jdata

    t = trees["voc"]
    ds, jds = (VOCPointDataset(t["ann_file"], t["img_prefix"], repeat=3),
               jdata.VOCPointDataset(t["ann_file"], t["img_prefix"], repeat=3))
    kw = dict(scales=((96, 160),), max_gt=4)
    pipe, jpipe = TrainPipeline(**kw), jdata.TrainPipeline(**kw)
    for drop_last in (False, True):
        a = list(TrainLoader(ds, pipe, 2, seed=5, num_threads=1, drop_last=drop_last).epoch(1))
        b = list(jdata.TrainLoader(jds, jpipe, 2, seed=5, num_threads=1,
                                   drop_last=drop_last).epoch(1))
        assert len(a) == len(b) >= 2
        _same(a, b, f"batches, drop_last={drop_last}")
    for rank in range(2):
        mine = TrainLoader(ds, pipe, 1, seed=5, process_index=rank, process_count=2)
        ref = jdata.TrainLoader(jds, jpipe, 1, seed=5, process_index=rank, process_count=2)
        for epoch in (0, 3):
            np.testing.assert_array_equal(mine._epoch_indices(epoch), ref._epoch_indices(epoch))
        assert mine.steps_per_epoch() == ref.steps_per_epoch()


def test_corruptions_match_jax_package(trees):
    """Every corruption of the suite at severity 3, and ``CorruptedDataset``
    over the VOC eval set: exactly equal."""
    from attentionshift_torch.data import corruptions as mine
    from attentionshift_torch.data.voc import VOCInstanceEvalDataset
    from attentionshift_tpu.data import corruptions as ref
    from attentionshift_tpu.data.voc import VOCInstanceEvalDataset as JVOC

    assert list(mine.CORRUPTIONS) == list(ref.CORRUPTIONS)
    img = _sample(48, 64, seed=4)["img"]
    for name in mine.CORRUPTIONS:
        _same(mine.corrupt(img, name, 3, seed=1), ref.corrupt(img, name, 3, seed=1), name)
    t = trees["voc"]
    a = mine.CorruptedDataset(VOCInstanceEvalDataset(t["split_file"], t["voc_root"]), "fog", 2)
    b = ref.CorruptedDataset(JVOC(t["split_file"], t["voc_root"]), "fog", 2)
    _same(a[1], b[1])
    _same(a.gt_instances(1), b.gt_instances(1))


def test_config_merge_from_options_matches_jax_package():
    """``--cfg-options`` overrides: literals parsed, new nodes made, the
    original left alone; the same tree as the JAX package's loader."""
    import os

    from attentionshift_torch.config import Config
    from attentionshift_tpu.config import Config as JConfig

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                        "attnshift_voc12aug.py")
    opts = ["model.test_score_thr=0.02", "data.val.voc_root=/data/voc", "data.test_scale=(96, 160)",
            "new.node.flag=True", "optimizer.base_lr=5e-05", "model.name=vit"]
    cfg = Config.fromfile(path)
    got = cfg.merge_from_options(opts)
    _same(got.to_dict(), JConfig.fromfile(path).merge_from_options(opts).to_dict())
    assert got.model.test_score_thr == 0.02 and got.data.test_scale == (96, 160)
    assert got.new.node.flag is True and got.model.name == "vit"
    assert cfg.model.test_score_thr == 0.05 and "new" not in cfg
    _same(cfg.merge_from_options({"a.b": [1, 2]}).to_dict()["a"], {"b": [1, 2]})
