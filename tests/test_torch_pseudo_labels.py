"""The pseudo-label dump of the port against the JAX tool.

``attentionshift_torch.tools.gen_pseudo_labels`` and the JAX package's
``tools/gen_pseudo_labels.py`` run in this process on the CPU (the JAX
tool with ``sys.argv`` patched and ``ATTNSHIFT_PLATFORM=cpu``), on the same
TINY weights (each package's own checkpoint of one set of random
variables), over the same synthetic point tree of distinct discs (a
landscape and a portrait image, so both buckets run), with the same draws:
the port's per-image step is handed the draws the JAX tool makes from
``PRNGKey(i)``, replayed from its key tree.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import (REPO, TINY, disc_tree, inputs, jax_model,  # noqa: E402
                                random_variables, replay_draws)

SCALE = (96, 160)  # --scale: a (96, 160) bucket, swapped for the portrait image
MODEL_KW = dict(TINY, max_gt=4, pad_tokens_to=128)
BOX_TOL = 1e-3  # px in the original frame
MIN_IOU = 0.99  # per annotation, decoded masks


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_gen_pseudo_labels", os.path.join(REPO, "tools", "gen_pseudo_labels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both tools' COCO dicts on the same weights, tree and draws."""
    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.tools import gen_pseudo_labels as gpl
    from attentionshift_torch.train import save_params
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet
    from attentionshift_tpu.train import save_params as jsave

    d = tmp_path_factory.mktemp("pseudo")
    tree = disc_tree(d / "discs", seed=1)
    cfg = d / "tiny.py"
    cfg.write_text(f"model = dict(**{MODEL_KW!r})\n"
                   f"data = dict(train=dict(ann_file={tree['ann_file']!r}, "
                   f"img_prefix={tree['img_prefix']!r}, repeat=4), max_gt=4)\n")
    jm = jax_model(**MODEL_KW)
    variables = random_variables(jm, inputs(64, 96, 4, 3))
    jckpt = jsave(str(d / "jax_epoch_1"), variables)
    pckpt = save_params(str(d / "epoch_1"), flax_to_torch(jax.tree.map(np.asarray, variables)))

    mp = pytest.MonkeyPatch()
    jout, pout = d / "jax.json", d / "port.json"
    mp.setenv("ATTNSHIFT_PLATFORM", "cpu")
    mp.setattr("sys.argv", ["gen_pseudo_labels.py", str(cfg), jckpt, "--out", str(jout),
                            "--scale", *map(str, SCALE)])
    _jax_tool().main()

    real = gpl.pseudo_label_image
    seed = jax.jit(lambda v, k, *a: jm.apply(v, *a, method=JDet.seed_debug, rngs={"sampling": k}))

    def with_jax_draws(model, sample, index, scale, max_gt, draws=None):
        args = gpl.prepare(sample, scale, max_gt)["args"]
        key = jax.random.PRNGKey(index)  # the JAX tool's key of image `index`
        dbg = jax.tree.map(np.asarray, seed(variables, key, *map(jnp.asarray, args)))
        draws = replay_draws(jm, variables, dbg, key, args[1], 4, args[0].shape[1:3])
        return real(model, sample, index, scale, max_gt, draws=draws)

    mp.setattr(gpl, "pseudo_label_image", with_jax_draws)
    got = gpl.main([str(cfg), pckpt, "--out", str(pout), "--scale", *map(str, SCALE),
                    "--device", "cpu"])
    mp.undo()
    yield got, json.loads(pout.read_text()), json.loads(jout.read_text())
    from test_torch_support import drop_weights
    drop_weights(d)


def test_dump_matches_jax_tool(dumps):
    """The same ``images`` (one pass over the unique images whatever the
    dataset's repeat), the same annotations in the same order with the same
    ids, image ids, categories, crowd flags and scores; boxes within 1e-3
    px in the original frame; every mask decoded at its image's size with
    IoU >= 0.99 against the JAX tool's and its ``area`` equal to its pixel
    sum. Measured: boxes and masks equal (worst box difference 0 px, worst
    IoU 1.0; the assertions below print them when they fail)."""
    from attentionshift_torch import native

    got, written, want = dumps
    assert got == written
    assert got["images"] == want["images"] and len(got["images"]) == 2
    assert [im["height"] > im["width"] for im in got["images"]] == [False, True]
    assert got["categories"] == want["categories"]
    ours, theirs = got["annotations"], want["annotations"]
    assert [a["id"] for a in ours] == [a["id"] for a in theirs] == list(range(1, len(ours) + 1))
    assert len(ours) == 6  # every disc of both images
    sizes = {im["id"]: (im["height"], im["width"]) for im in got["images"]}
    worst_box, worst_iou = 0.0, 1.0
    for a, b in zip(ours, theirs):
        for k in ("image_id", "category_id", "iscrowd", "score"):
            assert a[k] == b[k], (a["id"], k)
        worst_box = max(worst_box, float(np.abs(np.subtract(a["bbox"], b["bbox"])).max()))
        ma, mb = (native.rle_decode(native.rle_from_string(x["segmentation"]["counts"],
                                                           x["segmentation"]["size"]))
                  for x in (a, b))
        assert ma.shape == mb.shape == sizes[a["image_id"]]
        assert float(ma.sum()) == a["area"]
        union = (ma | mb).sum()
        worst_iou = min(worst_iou, float((ma & mb).sum() / union) if union else 1.0)
    assert worst_box <= BOX_TOL and worst_iou >= MIN_IOU, (worst_box, worst_iou)


def test_dump_raises_without_a_card_by_default(tmp_path):
    """Without ``--device`` the dump asks for the card, which is missing here."""
    from attentionshift_torch.tools import gen_pseudo_labels as gpl

    cfg = tmp_path / "tiny.py"
    cfg.write_text(f"model = dict(**{MODEL_KW!r})\n"
                   "data = dict(train=dict(ann_file='/nowhere', img_prefix='/nowhere'), max_gt=4)\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpl.main([str(cfg), "--out", str(tmp_path / "out.json")])
