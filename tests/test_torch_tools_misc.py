"""The port's user tools against the JAX package's, on the same inputs.

Each test runs the JAX tool (its script, in this process with ``sys.argv``
set; JAX stays on the CPU) and the port's twin
(``attentionshift_torch.tools.*.main(argv)``) on one synthetic input and
compares what they write: the VOC / SBD and Cityscapes converters' json
files byte for byte, ``eval_metric``'s and ``print_config``'s printed
JSON. ``publish_model`` has no JAX counterpart that runs without orbax:
its export is read back with ``train.restore_params``. No model runs.
"""

from __future__ import annotations

import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_tool(rel: str, argv: list, capsys) -> tuple[str, BaseException | None]:
    """Run the JAX tool ``rel`` as ``__main__`` with ``argv``; returns its
    stdout and the exception it ended with (None if it returned)."""
    saved = sys.argv
    sys.argv = [rel, *map(str, argv)]
    err = None
    try:
        runpy.run_path(os.path.join(REPO, rel), run_name="__main__")
    except Exception as e:  # noqa: BLE001 - compared with the twin's outcome
        err = e
    finally:
        sys.argv = saved
    return capsys.readouterr().out, err


def run_twin(main, argv: list, capsys) -> tuple[str, BaseException | None]:
    err = None
    try:
        main([str(a) for a in argv])
    except Exception as e:  # noqa: BLE001 - compared with the JAX tool's outcome
        err = e
    return capsys.readouterr().out, err


def same_outcome(a: BaseException | None, b: BaseException | None) -> bool:
    return (a is None and b is None) or (type(a) is type(b) and str(a) == str(b))


# ------------------------------------------------------------ converters

PALETTE = [c for i in range(256) for c in (i, (i * 37) % 256, (i * 91) % 256)]


def _palette_png(a: np.ndarray, path) -> None:
    im = Image.fromarray(a.astype(np.uint8), mode="P")
    im.putpalette(PALETTE)
    im.save(path)


@pytest.fixture(scope="module")
def voc_sbd_tree(tmp_path_factory):
    """A VOC tree (palette pngs with an ignore border, three images, one of
    them without an instance) and an SBD tree of ``.mat`` files written by
    ``scipy.io.savemat`` (one id shared with VOC, which the converter takes
    once, and two of its own)."""
    from scipy.io import savemat

    root = tmp_path_factory.mktemp("VOCconv")
    voc, sbd = root / "VOC2012", root / "SBD"
    for sub in ("JPEGImages", "SegmentationObject", "SegmentationClass",
                "ImageSets/Segmentation"):
        (voc / sub).mkdir(parents=True)
    for sub in ("cls", "inst", "img"):
        (sbd / sub).mkdir(parents=True)
    rng = np.random.RandomState(0)

    def scene(h, w, k):
        obj, cls = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
        for j in range(k):
            y, x = rng.randint(0, h - 12), rng.randint(0, w - 16)
            obj[y:y + rng.randint(5, 12), x:x + rng.randint(6, 16)] = j + 1
            cls[obj == j + 1] = rng.randint(1, 21)
        return obj, cls

    voc_ids = []
    for i, (h, w, k) in enumerate([(60, 80, 3), (75, 50, 2), (40, 40, 0)]):
        vid = f"2012_{i:06d}"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            voc / "JPEGImages" / f"{vid}.jpg")
        obj, cls = scene(h, w, k)
        if k:  # ignore border above the first instance
            ys, xs = np.nonzero(obj == 1)
            obj[max(ys.min() - 1, 0), xs.min():xs.max() + 1] = 255
            cls[max(ys.min() - 1, 0), xs.min():xs.max() + 1] = 255
        _palette_png(obj, voc / "SegmentationObject" / f"{vid}.png")
        _palette_png(cls, voc / "SegmentationClass" / f"{vid}.png")
        voc_ids.append(vid)
    (voc / "ImageSets/Segmentation/train.txt").write_text("\n".join(voc_ids) + "\n")
    sbd_ids = [voc_ids[0], "2008_000001", "2008_000002"]
    for vid, (h, w, k) in zip(sbd_ids, [(60, 80, 2), (50, 70, 4), (64, 48, 1)]):
        obj, cls = scene(h, w, k)
        savemat(sbd / "cls" / f"{vid}.mat", {"GTcls": {"Segmentation": cls}})
        savemat(sbd / "inst" / f"{vid}.mat", {"GTinst": {"Segmentation": obj}})
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(sbd / "img" / f"{vid}.jpg")
    (sbd / "train.txt").write_text("\n".join(sbd_ids) + "\n")
    return voc, sbd


@pytest.mark.parametrize("rle", [True, False], ids=["rle", "no-rle"])
@pytest.mark.parametrize("with_sbd", [False, True], ids=["voc", "voc+sbd"])
def test_pascal_voc_converter_matches_jax(voc_sbd_tree, tmp_path, capsys, rle, with_sbd):
    """Same json, byte for byte (RLE counts included), and the same printed
    line; the port's ``VOCPointDataset`` reads the twin's json."""
    from attentionshift_torch.data.voc import VOCPointDataset
    from attentionshift_torch.tools.dataset_converters import pascal_voc

    voc, sbd = voc_sbd_tree
    common = ["--voc-root", voc, "--split", "train"] + (["--sbd-root", sbd] if with_sbd else []) \
        + ([] if rle else ["--no-rle"])
    want, werr = run_jax_tool("tools/dataset_converters/pascal_voc.py",
                              common + ["--out", tmp_path / "jax.json"], capsys)
    got, gerr = run_twin(pascal_voc.main, common + ["--out", tmp_path / "port.json"], capsys)
    assert werr is None and gerr is None, (werr, gerr)
    assert got.replace("port.json", "jax.json") == want
    mine = (tmp_path / "port.json").read_bytes()
    assert mine == (tmp_path / "jax.json").read_bytes()
    d = json.loads(mine)
    assert len(d["images"]) == (4 if with_sbd else 2) and len(d["categories"]) == 20
    assert all(("segmentation" in a) == rle for a in d["annotations"])
    ds = VOCPointDataset(str(tmp_path / "port.json"), str(voc / "JPEGImages"))
    assert len(ds) == len(d["images"])
    s = ds[0]
    assert s["points"].shape == (3, 2)
    assert s["labels"].tolist() == [a["category_id"] - 1 for a in d["annotations"][:3]]


def test_cityscapes_converter_matches_jax(tmp_path, capsys):
    """The synthetic gtFine tree of ``test_tools_misc.py``: the same val
    json byte for byte, the same printed lines (the missing train and test
    splits skipped) and the same outcome."""
    from attentionshift_torch.tools.dataset_converters import cityscapes

    root = tmp_path / "cs"
    for sub in ("leftImg8bit/val/cityA", "gtFine/val/cityA"):
        (root / sub).mkdir(parents=True)
    h, w = 40, 60
    name = "cityA_000000_000019"
    Image.new("RGB", (w, h)).save(root / "leftImg8bit/val/cityA" / f"{name}_leftImg8bit.png")
    inst = np.zeros((h, w), np.int32)
    inst[5:15, 5:25] = 26000  # car instance 0
    inst[20:35, 30:50] = 24001  # person instance 1
    inst[2:6, 40:55] = 25  # rider crowd region (id < 1000)
    inst[0:3, 0:5] = 29000  # caravan: has instances but ignored in eval -> dropped
    Image.fromarray(inst, mode="I").save(root / "gtFine/val/cityA" / f"{name}_gtFine_instanceIds.png")
    Image.fromarray((inst // 1000).astype(np.uint8)).save(
        root / "gtFine/val/cityA" / f"{name}_gtFine_labelIds.png")
    want, werr = run_jax_tool("tools/dataset_converters/cityscapes.py",
                              [root, "-o", tmp_path / "jax"], capsys)
    got, gerr = run_twin(cityscapes.main, [root, "-o", tmp_path / "port"], capsys)
    assert same_outcome(werr, gerr), (werr, gerr)
    assert got == want and "skipping train" in got and "skipping test" in got
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "instancesonly_filtered_gtFine_val.json"]
    mine = (tmp_path / "port" / names[0]).read_bytes()
    assert mine == (tmp_path / "jax" / names[0]).read_bytes()
    d = json.loads(mine)
    assert sorted(a["category_id"] for a in d["annotations"]) == [24, 25, 26]
    assert [c["id"] for c in d["categories"]] == [24, 25, 26, 27, 28, 31, 32, 33]


# ----------------------------------------------------------- eval_metric


def _box_mask(h, w, y, x, hh, ww):
    m = np.zeros((h, w), bool)
    m[y:y + hh, x:x + ww] = True
    return m


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """A VOC and a COCO dump of two images with imperfect predictions: the
    third instance of image 0 predicted with a wrong class (so missed), a
    shifted mask, a low-scored false positive and (COCO) a crowd region."""
    d = tmp_path_factory.mktemp("dumps")
    h, w = 48, 64
    g = [[_box_mask(h, w, 2, 2, 14, 20), _box_mask(h, w, 25, 30, 15, 20),
          _box_mask(h, w, 5, 40, 10, 12)],
         [_box_mask(h, w, 10, 10, 20, 20), _box_mask(h, w, 30, 5, 12, 30)]]
    gl = [np.asarray([1, 3, 3]), np.asarray([7, 1])]
    p = [[g[0][0], _box_mask(h, w, 28, 33, 15, 20), g[0][2], _box_mask(h, w, 40, 50, 6, 6)],
         [g[1][0], _box_mask(h, w, 30, 8, 12, 30)]]
    pl = [np.asarray([1, 3, 5, 3]), np.asarray([7, 1])]  # instance 3 of image 0: wrong class
    ps = [np.asarray([0.9, 0.8, 0.7, 0.2], np.float32), np.asarray([0.95, 0.6], np.float32)]
    out = {}
    for kind in ("voc", "coco"):
        crowd = [np.zeros(3, bool), np.asarray([False, kind == "coco"])]
        preds = dict(masks=[np.stack(m) for m in p], labels=pl, scores=ps)
        gts = dict(masks=[np.stack(m) for m in g], labels=gl, crowd=crowd)
        path = d / f"{kind}.pkl"
        with open(path, "wb") as f:
            pickle.dump(dict(preds=preds, gts=gts, is_coco=kind == "coco", num_classes=20), f)
        out[kind] = path
    return out


@pytest.mark.parametrize("kind,flags", [("voc", ["--per-class"]),
                                        ("voc", ["--iou", "0.3", "0.6", "--per-class"]),
                                        ("voc", ["--coco"]), ("coco", [])],
                         ids=["voc-per-class", "voc-iou", "voc-as-coco", "coco"])
def test_eval_metric_matches_jax(dumps, capsys, kind, flags):
    """The same printed JSON, and metrics that are not all 1.0."""
    from attentionshift_torch.tools.analysis import eval_metric

    want, werr = run_jax_tool("tools/analysis/eval_metric.py", [dumps[kind], *flags], capsys)
    got, gerr = run_twin(eval_metric.main, [dumps[kind], *flags], capsys)
    assert werr is None and gerr is None, (werr, gerr)
    assert got == want
    res = json.loads(got)
    scores = [v for k, v in res.items() if not k.startswith("per_class")]
    assert all(np.isfinite(scores)) and min(scores) < 1.0 and max(scores) > 0.0
    assert any(k.startswith("per_class") for k in res) == ("--per-class" in flags
                                                          and "--coco" not in flags)


# ---------------------------------------------------------- print_config


def test_print_config_matches_jax(tmp_path, capsys):
    """``_base_`` merging and ``--cfg-options``: the same printed JSON."""
    from attentionshift_torch.tools.misc import print_config

    base = tmp_path / "base.py"
    base.write_text("model = dict(depth=4, heads=dict(a=1, b=2))\nruntime = dict(seed=0)\n"
                    "data = dict(scales=[(480, 1333), (512, 1333)])\n")
    leaf = tmp_path / "leaf.py"
    leaf.write_text(f"_base_ = [{str(base)!r}]\nmodel = dict(num_heads=2, heads=dict(b=3))\n")
    opts = ["--cfg-options", "model.depth=8", "runtime.seed=3", "data.flip=0.5"]
    want, werr = run_jax_tool("tools/misc/print_config.py", [leaf, *opts], capsys)
    got, gerr = run_twin(print_config.main, [leaf, *opts], capsys)
    assert werr is None and gerr is None, (werr, gerr)
    assert got == want
    assert json.loads(got)["model"] == {"depth": 8, "heads": {"a": 1, "b": 3}, "num_heads": 2}


# --------------------------------------------------------- publish_model


def test_publish_model_strips_the_optimizer(tmp_path, capsys):
    """A ``save_checkpoint`` file after one optimizer step -> the twin ->
    ``restore_params``: every parameter and buffer equal, and the export
    holds no optimizer state and no counters."""
    from attentionshift_torch.tools import publish_model
    from attentionshift_torch.train import (TrainState, build_optimizer, restore_params,
                                            save_checkpoint)

    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(8, 4), torch.nn.BatchNorm1d(4))
    state = TrainState.create(model, build_optimizer(model, accumulate_steps=1, warmup_iters=1))
    state.apply_gradients([torch.randn(p.shape, generator=gen) for p in model.parameters()])
    ckpt = save_checkpoint(str(tmp_path / "work"), state)
    out = publish_model.main([ckpt, str(tmp_path / "final")])
    assert capsys.readouterr().out.strip() == f"published weights-only checkpoint to {out}"
    saved = torch.load(out, map_location="cpu", weights_only=True)
    assert sorted(saved) == ["params"]
    got, want = restore_params(out), model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert "opt_state" in torch.load(ckpt, map_location="cpu", weights_only=True)
