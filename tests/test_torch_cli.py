"""``evaluate`` end to end and the evaluation CLI of the port.

Both packages' ``evaluate`` on the same TINY weights over synthetic VOC
and COCO trees, single-scale and aug-test (one scale with flip here: the
CLI's six are cut for the CPU, and the multi-scale merge is held in
``test_torch_eval.py``), then the port's
``attentionshift_torch.tools.test`` run in-process on the CPU: its last
stdout line is the metric dict ``evaluate`` returns for the same model.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_support import (EVAL_KW, PROB_TOL, close, coco_tree, eval_models,  # noqa: E402
                                voc_tree)

# metric dicts: the same detections scored by the same numpy code; a mask
# pixel whose probability sits within PROB_TOL of the 0.5 threshold can flip
# and move an IoU, so the metrics are held to 1e-3 rather than exactly
METRIC_TOL = 1e-3
TEST_SCALE = (96, 160)
AUG_SCALES = [(64, 128)]


@pytest.fixture(scope="module")
def models():
    from attentionshift_tpu.eval.aug_test import AugTester as JAugTester

    m = eval_models()
    m["jaug"] = JAugTester(m["jmodel"], m["variables"], scales=AUG_SCALES, flip=True)
    return m


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return dict(voc=voc_tree(tmp_path_factory.mktemp("VOC2012")),
                coco=coco_tree(tmp_path_factory.mktemp("coco")))


def _node(trees, data):
    if data == "voc":
        return dict(split_file=trees["voc"]["split_file"], voc_root=trees["voc"]["voc_root"])
    return dict(type="COCOEvalDataset", **trees["coco"])


@pytest.fixture(scope="module")
def evaluated(models, trees, tmp_path_factory):
    """Both packages' ``evaluate`` on both trees, single-scale and
    aug-test, each with its per-image predictions dumped."""
    from attentionshift_torch.data import build_eval_dataset
    from attentionshift_torch.eval import AugTester, evaluate
    from attentionshift_tpu.data import build_eval_dataset as jbuild
    from attentionshift_tpu.eval.runner import evaluate as jevaluate

    out = tmp_path_factory.mktemp("dumps")
    res = {}
    for data in ("voc", "coco"):
        node = _node(trees, data)
        for mode in ("single", "aug"):
            kw = dict(test_scale=TEST_SCALE, num_classes=20, verbose=False)
            mine, ref = out / f"{data}-{mode}-port.pkl", out / f"{data}-{mode}-jax.pkl"
            got = evaluate(models["port"], build_eval_dataset(node), dump_path=str(mine),
                           aug_tester=(AugTester(models["port"], AUG_SCALES) if mode == "aug"
                                       else None), **kw)
            want = jevaluate(models["jmodel"], models["variables"], jbuild(node),
                             dump_path=str(ref),
                             aug_tester=models["jaug"] if mode == "aug" else None, **kw)
            with open(mine, "rb") as f, open(ref, "rb") as g:
                res[data, mode] = (got, want, pickle.load(f), pickle.load(g))
    return res


@pytest.mark.parametrize("data", ["voc", "coco"])
@pytest.mark.parametrize("mode", ["single", "aug"])
def test_evaluate_matches_jax(evaluated, data, mode):
    """``evaluate`` end to end on the same TINY weights with the lowered
    score floor: per-image labels and ground truth exactly equal, scores
    ``PROB_TOL``, pasted masks equal but for pixels at the threshold, the
    metric dicts (VOC mAP@{0.25, 0.5, 0.75}; COCO AP/AP50/AP75) within
    ``METRIC_TOL``, with detections on every image."""
    got, want, dump, jdump = evaluated[data, mode]
    keys = ["AP", "AP50", "AP75"] if data == "coco" else ["mAP@0.25", "mAP@0.5", "mAP@0.75"]
    assert sorted(got) == sorted(want) == sorted(keys)
    for k in keys:
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    assert dump["is_coco"] == jdump["is_coco"] == (data == "coco")
    assert dump["num_classes"] == jdump["num_classes"] == 20
    for a, b in zip(dump["preds"]["labels"], jdump["preds"]["labels"], strict=True):
        np.testing.assert_array_equal(a, b)
        assert len(a) > 0
    for a, b in zip(dump["preds"]["scores"], jdump["preds"]["scores"], strict=True):
        close(a, b, PROB_TOL)
    for a, b in zip(dump["preds"]["masks"], jdump["preds"]["masks"], strict=True):
        assert a.shape == b.shape and (a != b).mean() < 1e-3
    for key in ("masks", "labels", "crowd"):
        for a, b in zip(dump["gts"][key], jdump["gts"][key], strict=True):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------------ CLI


@pytest.fixture(scope="module")
def cli_setup(models, trees, tmp_path_factory):
    """A config of the TINY model over the VOC tree, and the port model's
    weights exported with ``save_params``."""
    from attentionshift_torch.train import save_params

    d = tmp_path_factory.mktemp("cli")
    cfg = d / "tiny_voc.py"
    cfg.write_text(f"model = dict(**{EVAL_KW!r})\n"
                   f"data = dict(val=dict(split_file='/nowhere/val.txt', voc_root='/nowhere'), "
                   f"test_scale={TEST_SCALE!r})\n")
    ckpt = save_params(str(d / "epoch_1"), models["port"].state_dict())
    voc = _node(trees, "voc")
    opts = ["--cfg-options", f"data.val.split_file={voc['split_file']}",
            f"data.val.voc_root={voc['voc_root']}"]
    return str(cfg), ckpt, opts, d


def _last_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_cli_aug_test_prints_evaluate_metrics(cli_setup, evaluated, capsys, monkeypatch):
    """``tools.test CFG CKPT --aug-test --limit 2 --device cpu --dump-preds
    P --out F`` in-process (the six-scale list cut to ``AUG_SCALES``): the
    last stdout line parses to exactly the metric dict ``evaluate`` gave
    the same model, ``--out`` holds it too, and the dumped predictions
    equal ``evaluate``'s."""
    from attentionshift_torch.tools import test as cli

    cfg, ckpt, opts, d = cli_setup
    monkeypatch.setattr(cli, "AUG_SCALES", AUG_SCALES)
    dump, out = d / "preds.pkl", d / "eval.json"
    got = cli.main([cfg, ckpt, "--aug-test", "--limit", "2", "--device", "cpu", "--dump-preds",
                    str(dump), "--out", str(out), *opts])
    printed = _last_line(capsys)
    want, _, want_dump, _ = evaluated["voc", "aug"]
    assert printed == got == want
    assert json.loads(out.read_text()) == want
    with open(dump, "rb") as f:
        mine = pickle.load(f)
    for key in ("labels", "scores", "masks"):
        for a, b in zip(mine["preds"][key], want_dump["preds"][key], strict=True):
            np.testing.assert_array_equal(a, b)


def test_cli_single_scale_and_its_contract(cli_setup, evaluated, capsys):
    """Single-scale through the CLI equals ``evaluate``; without a
    checkpoint every parameter and buffer is zero (the JAX CLI's
    template); ``--limit 1`` scores one image; a ``model_type =
    "mask_rcnn"`` config builds the refinement stage's Mask R-CNN in f32
    (zero without a checkpoint) and scores an image with a checkpoint of
    its own."""
    from attentionshift_torch.tools import test as cli

    cfg, ckpt, opts, _ = cli_setup
    assert cli.main([cfg, ckpt, "--device", "cpu", *opts]) == evaluated["voc", "single"][0]
    assert _last_line(capsys) == evaluated["voc", "single"][0]
    args = cli.parse_args([cfg, "--device", "cpu", *opts])
    _, model, dataset, aug = cli.build(args)
    assert aug is None and len(dataset) == 2 and model.dtype == torch.float32
    assert all(float(t.abs().max()) == 0.0 for t in model.state_dict().values())
    one = cli.main([cfg, ckpt, "--device", "cpu", "--limit", "1", *opts])
    assert sorted(one) == ["mAP@0.25", "mAP@0.5", "mAP@0.75"]
    from attentionshift_torch.models.mask_rcnn import MaskRCNN
    from attentionshift_torch.train import save_params

    d = cli_setup[3]
    refine_kw = dict(num_classes=20, rpn_channels=32, num_proposals=16, rpn_nms_pre=32,
                     rcnn_samples=8, mask_sample_cap=4, depths=(1, 1, 1, 1), test_max_per_img=10,
                     test_score_thr=0.02)
    rcfg = d / "tiny_refine.py"
    rcfg.write_text(f"model_type = 'mask_rcnn'\nmodel = dict(**{refine_kw!r})\n"
                    + cfg_text_data(cfg))
    _, rmodel, _, _ = cli.build(cli.parse_args([str(rcfg), "--device", "cpu", *opts]))
    assert isinstance(rmodel, MaskRCNN) and rmodel.dtype == torch.float32
    assert all(float(t.abs().max()) == 0.0 for t in rmodel.state_dict().values())
    rckpt = save_params(str(d / "refine_epoch_1"),
                        MaskRCNN(device="cpu", **refine_kw).init_weights(0).state_dict())
    one = cli.main([str(rcfg), rckpt, "--device", "cpu", "--limit", "1", *opts])
    assert sorted(one) == ["mAP@0.25", "mAP@0.5", "mAP@0.75"]


def cfg_text_data(cfg: str) -> str:
    """The ``data`` line of a config file."""
    return "".join(line for line in open(cfg).read().splitlines(True) if line.startswith("data"))


def test_cli_scales_and_device_default(cli_setup):
    """The CLI's aug-test protocol is the reference's six scales x flip
    (``tools/test.py:114-117``), and with no ``--device`` the model is
    asked for on ``cuda``: on a machine without a card that raises."""
    from attentionshift_torch.tools import test as cli

    assert cli.AUG_SCALES == [(800, 1333), (600, 1333), (400, 1333),
                              (800, 1000), (600, 1000), (400, 1000)]
    cfg, ckpt, opts, _ = cli_setup
    args = cli.parse_args([cfg, ckpt, "--aug-test", *opts])
    assert args.device is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.build(args)
