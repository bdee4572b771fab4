"""The diagnosis twins against the JAX tools, on the CPU.

``attentionshift_torch.tools.analysis.diagnose_det`` and ``probe_rpn``
twin the JAX tools of the same names. Both sides run a narrow flagship
(``test_torch_learning_check.NARROW``: 64 wide, 4 blocks, 48 proposals)
at 512x512 on the same weights: the JAX tool's own ``model.init`` (key 0),
captured from its ``build_optimizer`` call and converted with
``convert.load_flax``. The JAX tools are run from their source (``main``
taken with ``ast``, the model class narrowed, ``sys.argv`` set); importing
them would set JAX's compile cache and build the full-width model.
``diagnose_det`` runs with ``--steps 0``; ``probe_rpn`` with ``--ckpt``
on that weights' orbax export (JAX) and ``save_params`` export (port).
No probe of either report reads a random draw at these settings: the
probes are deterministic, the pseudo boxes come from Stage A and the
MIL choice, and the sampled positives of ``random_sample`` are
min(positives, 128) whatever the draw.

Tolerance: the tools print their numbers rounded (3-5 places); counts,
labels and argmaxes must be equal, every other number within one unit of
its last printed digit (f32 sums of the two packages in another order
can flip that digit), except ``frac_gt_05``: the share of a level's
random-init objectness above 0.5, where the scores sit within 1e-2 of
0.5 and f32 rounding flips a few anchors of ~10^4 (within 2e-4).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from attentionshift_torch.tools.analysis import diagnose_det, probe_rpn  # noqa: E402
from test_torch_learning_check import NARROW, jax_functions  # noqa: E402
from test_torch_support import drop_weights  # noqa: E402

SCOPE = dict(B=1, H=512, W=512, G=8)


def narrow_jax_detector(**kw):
    """The JAX tools' ``AttnShiftDetector(...)`` call, narrowed and in f32
    (the port's CPU dtype)."""
    from attentionshift_tpu.models.detector import AttnShiftDetector

    kept = {k: v for k, v in kw.items() if k not in NARROW and k != "dtype"}
    return AttnShiftDetector(**kept, **NARROW)


def jax_tool(rel: str, captured: dict, **extra) -> dict:
    """The JAX tool ``rel``'s ``main`` (and helpers) in a namespace with the
    narrow model; its ``build_optimizer`` keeps the variables it is handed
    in ``captured``."""
    from attentionshift_tpu import train as jtrain

    lc = jax_functions("tools/analysis/learning_check.py", ("make_sample", "box_iou"), **SCOPE)

    def build_optimizer(params, **kw):
        captured["variables"] = params
        return jtrain.build_optimizer(params, **kw)

    names = tuple(extra.pop("names", ("main",)))
    return jax_functions(rel, names, argparse=argparse, json=json, os=os, sys=sys, time=time,
                         jax=jax, jnp=jnp, AttnShiftDetector=narrow_jax_detector,
                         TrainState=jtrain.TrainState, build_optimizer=build_optimizer,
                         make_train_step=jtrain.make_train_step, make_sample=lc["make_sample"],
                         box_iou=lc["box_iou"], **SCOPE, **extra)


def run_jax(ns: dict, argv: list, capsys, monkeypatch) -> list:
    """The JAX tool's main under ``argv``: its JSON lines."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    ns["main"]()
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


def port_model(variables):
    """A ``build_model`` seam: the narrow port model on ``variables``."""
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.models import AttnShiftDetector

    def build(device):
        model = AttnShiftDetector(device=device, **NARROW)
        return load_flax(model, jax.tree.map(np.asarray, variables))

    return build


def digits(x) -> int:
    """Decimal places of a printed number."""
    text = repr(float(x))
    return 0 if "e" in text else len(text.split(".")[1].rstrip("0"))


def same_report(got, want, path="", loose=()):
    """Field by field: ints and strings equal, floats within one unit of the
    last printed digit of the wider of the two (``loose``: names within
    2e-4)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            same_report(got[k], want[k], f"{path}.{k}", loose)
    elif isinstance(want, list):
        assert len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            same_report(a, b, f"{path}[{i}]", loose)
    elif isinstance(want, float) or isinstance(got, float):
        tol = 2e-4 if path.rsplit(".", 1)[-1] in loose else 10.0 ** -max(digits(got), digits(want), 1)
        assert abs(got - want) <= tol * (1 + 1e-6), (path, got, want, tol)
    else:
        assert got == want, (path, got, want)


@pytest.fixture(scope="module")
def jax_diagnosis():
    """The JAX diagnose_det at ``--steps 0`` on one held-out image: its row
    and the variables its ``model.init`` made."""
    captured = {}
    ns = jax_tool("tools/analysis/diagnose_det.py", captured)
    with pytest.MonkeyPatch.context() as mp:
        import io
        import contextlib

        buf = io.StringIO()
        mp.setattr(sys, "argv", ["diagnose_det", "--steps", "0", "--eval-images", "2"])
        with contextlib.redirect_stdout(buf):
            ns["main"]()
    rows = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    return rows, captured["variables"]


def test_diagnose_det_matches_the_jax_tool(jax_diagnosis, tmp_path, monkeypatch, capsys):
    """``--steps 0`` on the JAX tool's init: the two held-out rows (RPN
    recall, the box head on the true boxes, the detections, the pasted
    mask IoU) field by field; the rows are the lines the twin printed. The
    port's ``--ckpt`` (no training; a ``save_params`` export of the same
    weights loaded into a model of another init) gives the same rows."""
    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.train import save_params

    want, variables = jax_diagnosis
    monkeypatch.setattr(diagnose_det, "build_model", port_model(variables))
    got = diagnose_det.main(["--steps", "0", "--eval-images", "2", "--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert printed == got and len(got) == 2
    same_report(got, want)
    assert got[0]["n_det"] > 0 and len(got[0]["det_scores_top5"]) == 5
    pfile = tmp_path / "params.pt"
    save_params(str(pfile), flax_to_torch(jax.tree.map(np.asarray, variables)))
    monkeypatch.setattr(diagnose_det, "build_model", _narrow)
    assert diagnose_det.main(["--ckpt", str(pfile), "--eval-images", "2", "--device", "cpu"]) == got
    assert "train wall" not in capsys.readouterr().out
    drop_weights(pfile)


def test_probe_rpn_matches_the_jax_tool(jax_diagnosis, tmp_path, monkeypatch, capsys):
    """``--ckpt`` on the JAX tool's init (an orbax export for the JAX tool,
    a ``save_params`` export for the twin): both reports (train0, held0)
    field by field."""
    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.train import save_params
    from attentionshift_tpu.core.anchors import grid_anchors, grid_anchors_per_level
    from attentionshift_tpu.core.assign import max_iou_assign, random_sample
    from attentionshift_tpu.models.rpn import rpn_proposals
    from attentionshift_tpu.train.checkpoint import save_params as jsave

    _, variables = jax_diagnosis
    jdir, pfile = tmp_path / "jax_params", tmp_path / "params.pt"
    jsave(str(jdir), variables)
    save_params(str(pfile), flax_to_torch(jax.tree.map(np.asarray, variables)))
    ns = jax_tool("tools/analysis/probe_rpn.py", {}, names=("main", "iou_matrix"),
                  grid_anchors=grid_anchors, grid_anchors_per_level=grid_anchors_per_level,
                  max_iou_assign=max_iou_assign, random_sample=random_sample,
                  rpn_proposals=rpn_proposals)
    want = run_jax(ns, ["--ckpt", str(jdir)], capsys, monkeypatch)
    monkeypatch.setattr(probe_rpn, "build_model", port_model(variables))
    got = probe_rpn.main(["--ckpt", str(pfile), "--device", "cpu"])
    assert [r["tag"] for r in got] == [r["tag"] for r in want] == ["train0", "held0"]
    same_report(got, want, loose=("frac_gt_05",))
    assert all(r["n_anchors_iou50_true"] > 0 and r["n_valid_props"] == 48 for r in got)
    drop_weights(pfile)
    import shutil

    shutil.rmtree(jdir, ignore_errors=True)


def _narrow(device):
    from attentionshift_torch.models import AttnShiftDetector

    return AttnShiftDetector(device=device, **NARROW).init_weights(0)


def test_diagnose_det_main_trains_on_cpu(monkeypatch, capsys):
    """Two train steps then the probes: the metric lines at steps 0 and 1
    (every 250th and the last), finite losses, the train wall line, one
    row per held-out image with the JAX tool's keys, values in range."""
    monkeypatch.setattr(diagnose_det, "build_model", _narrow)
    rows = diagnose_det.main(["--steps", "2", "--train-images", "2", "--eval-images", "1",
                              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    metrics = [json.loads(x) for x in lines[:2]]
    assert [m["step"] for m in metrics] == [0, 1]
    assert all(np.isfinite(v) for m in metrics for v in m.values())
    assert lines[2].startswith("train wall ") and json.loads(lines[3]) == rows[0]
    assert list(rows[0]) == ["img", "true_labels", "rpn_recall", "truebox_p_true",
                             "truebox_p_maxfg", "truebox_argmax", "truebox_p_bg", "n_det",
                             "det_scores_top5", "det_best_box_iou", "det_mask_iou"]
    r = rows[0]
    assert all(0.0 <= x <= 1.0 for k in ("rpn_recall", "truebox_p_true", "truebox_p_maxfg",
                                         "truebox_p_bg", "det_best_box_iou") for x in r[k])
    assert 0 <= r["n_det"] <= NARROW["test_max_per_img"] and 0.0 <= r["det_mask_iou"] <= 1.0


def test_probe_rpn_save_then_restore_gives_the_same_report(tmp_path, monkeypatch, capsys):
    """Two train steps with ``--save-ckpt``, then ``--ckpt`` on that file:
    the metric line and the saved line first, and the two runs' reports
    equal (the restored model is the trained one)."""
    monkeypatch.setattr(probe_rpn, "build_model", _narrow)
    ckpt = tmp_path / "probe.pt"
    first = probe_rpn.main(["--steps", "2", "--save-ckpt", str(ckpt), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert np.isfinite(json.loads(lines[0])["loss_total"])
    assert lines[1] == f"saved {ckpt}"
    again = probe_rpn.main(["--ckpt", str(ckpt), "--device", "cpu"])
    assert first == again
    keys = {"tag", "objectness_per_level", "n_anchors_iou50_true", "score_elsewhere_max",
            "cand_n", "cand_ok_frac", "cand_nan_scores", "cand_nan_boxes",
            "cand_degenerate_examples", "n_valid_props", "pseudo_boxes", "pseudo_vs_true_iou",
            "rpn_train_n_pos", "rpn_train_n_neg", "rpn_train_sampled_pos"}
    assert all(keys <= set(r) for r in first)
    assert all(r["rpn_train_sampled_pos"] == min(r["rpn_train_n_pos"], 128) for r in first)
    drop_weights(ckpt)
