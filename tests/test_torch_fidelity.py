"""The fidelity study's twin against the JAX tool, on the CPU.

``attentionshift_torch.tools.analysis.fidelity_study`` twins
``tools/analysis/fidelity_study.py``. The JAX tool is taken from its
source (its constants, functions and ``Acc``, with ``ast``): importing it
would point JAX's compile cache at the repository, and its ``main`` writes
``FIDELITY.md`` beside the repository's tools. Here its ``__file__`` lies
under ``tmp_path``, so its report lands there, and the repository's
``FIDELITY.md`` is checked byte for byte after the tests.

Both sides run a narrow flagship (``test_torch_learning_check.NARROW``)
on the same weights (the JAX init, converted), at ``--eval-size`` 256 x
256 on one held-out image; every draw of the twin is replayed from the
JAX tool's keys (``replay``): the seed points of ``seed_pseudo_gt``
(keys 7 and 8), of the isolated stride (key 3) and of the constructed
features (key 11, inside ``masks_and_centers``), and the mask-point
noise. Tolerances are stated per test.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import hashlib
import io
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

from attentionshift_torch.tools.analysis import fidelity_study as fs  # noqa: E402
from test_torch_learning_check import NARROW  # noqa: E402
from test_torch_support import REPO, drop_weights, random_variables, replay_draws  # noqa: E402

REL = "tools/analysis/fidelity_study.py"
FIDELITY_MD = os.path.join(REPO, "FIDELITY.md")


def digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module", autouse=True)
def fidelity_md_untouched():
    """``FIDELITY.md`` holds the same bytes after every test of this file."""
    before = digest(FIDELITY_MD)
    yield
    assert digest(FIDELITY_MD) == before


def jax_study(file: str, **scope) -> dict:
    """The JAX tool's top-level constants, functions and classes in a
    namespace of their own, with ``__file__`` set to ``file``."""
    from attentionshift_tpu import train as jtrain
    from attentionshift_tpu.models.detector import AttnShiftDetector

    with open(os.path.join(REPO, REL)) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef, ast.Assign))]
    ns = dict(np=np, jax=jax, jnp=jnp, json=json, os=os, sys=sys, time=time, argparse=argparse,
              AttnShiftDetector=AttnShiftDetector, TrainState=jtrain.TrainState,
              build_optimizer=jtrain.build_optimizer, make_train_step=jtrain.make_train_step,
              __file__=file, __name__="jax_fidelity_study")
    exec(compile(ast.Module(body=body, type_ignores=[]), REL, "exec"), ns)
    ns.update(scope)
    return ns


def unrounded(ns_or_module, monkeypatch):
    """Take the rounding out of a namespace's or module's reports."""
    ident = lambda x, n=None: float(x)  # noqa: E731
    if isinstance(ns_or_module, dict):
        ns_or_module["round"] = ident
    else:
        monkeypatch.setattr(ns_or_module, "round", ident, raising=False)


def close_report(got, want, rel, path=""):
    """Same keys and structure; numbers within ``rel`` of the larger
    magnitude (absolute below 1), None where the other is None."""
    if isinstance(want, dict):
        assert sorted(map(str, got)) == sorted(map(str, want)), path
        for k in want:
            close_report(got[k] if k in got else got[str(k)], want[k], rel, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            close_report(a, b, rel, f"{path}[{i}]")
    elif want is None or got is None:
        assert got is None and want is None, (path, got, want)
    else:
        assert abs(float(got) - float(want)) <= rel * max(1.0, abs(float(want))), (path, got, want)


# ------------------------------------------------------------ helpers alone


def fake_seed_output(rs, h: int, s: int = 1) -> dict:
    """A ``seed_pseudo_gt``-shaped output at (h / s) maps with seeded boxes,
    masks, layers, centers and maps."""
    g = fs.G
    boxes = np.sort(rs.rand(1, g, 2, 2) * h, axis=2).transpose(0, 1, 3, 2).reshape(1, g, 4)
    return dict(
        pseudo_gt_bboxes=boxes[..., [0, 2, 1, 3]].astype(np.float32),
        pseudo_gt_masks=(rs.rand(1, g, h, h) > 0.6).astype(np.uint8),
        best_attn_idx=rs.randint(0, 3, (1, g)).astype(np.int32),
        semantic_centers=(rs.rand(1, g, 6, 2) * h).astype(np.float32),
        semantic_centers_valid=rs.rand(1, g, 6) > 0.5,
        map_cos_fg=rs.rand(1, g, h // s, h // s).astype(np.float32),
    )


def test_helpers_equal_the_jax_tools(tmp_path):
    """``box_iou``, ``center_drift``, ``pct`` and ``Acc`` (``add`` over three
    images with a stride-2 map on one side, then ``report``) on seeded
    inputs: equal to the JAX tool's, exactly (the same numpy arithmetic);
    ``make_sample`` bitwise at 512 and at 256."""
    ns = jax_study(str(tmp_path / "fidelity_study.py"))
    rs = np.random.RandomState(0)
    for _ in range(50):
        a, b = rs.rand(4) * 100, rs.rand(4) * 100
        a[2:] += a[:2]
        b[2:] += b[:2]
        assert fs.box_iou(a, b) == ns["box_iou"](a, b)
    for n in (0, 1, 5):
        ca, cb = rs.rand(6, 2) * 50, rs.rand(6, 2) * 50
        va, vb = rs.rand(6) < 0.6, np.arange(6) < n
        assert fs.center_drift(ca, va, cb, vb) == ns["center_drift"](ca, va, cb, vb)
    for v in ([], [3.0], list(rs.rand(17))):
        for qs in ((50, 90, 100), (10, 50)):
            assert fs.pct(v, qs) == ns["pct"](v, qs)
    got, want = fs.Acc(), ns["Acc"]()
    for _ in range(3):
        val = rs.rand(fs.G) < 0.6
        ra, rb = fake_seed_output(rs, 32, 2), fake_seed_output(rs, 32)
        got.add(ra, rb, val)
        want.add(ra, rb, val)
    assert got.report() == want.report() and got.report()["n"] > 0
    for size in (None, (256, 256)):
        r1, r2 = np.random.RandomState(100), np.random.RandomState(100)
        for i in range(2):
            kw = dict(zip(("h", "w"), size)) if size else {}
            for x, y in zip(fs.make_sample(r1, i, **kw), ns["make_sample"](r2, i, **kw)):
                assert x.dtype == y.dtype and np.array_equal(x, y)


# ------------------------------------------------------------- draw replay


class Key:
    """A JAX key seed standing in for a generator: the twin's draws are
    replaced by the JAX tool's."""

    def __init__(self, seed: int):
        self.seed = seed


def gumbel_noise(k_points, g: int, n: int):
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (n,)))
                                      for k in jax.random.split(k_points, g)]))


def replay(monkeypatch, variables=None):
    """Every draw of the twin from the JAX tool's keys: ``generator(seed)``
    becomes ``Key(seed)``, and the callees that draw take the JAX draws of
    that key instead (``masks_and_centers`` splits its key as the JAX
    engine does; ``seed_pseudo_gt`` as the JAX detector does, from the
    port's own best-layer CAMs; ``sample_fgbg_points`` takes the key as
    is)."""
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.pseudo import engine, refine
    from attentionshift_tpu.pseudo.cam import norm_attns
    from attentionshift_tpu.pseudo.refine import sample_fgbg_points as jsample

    monkeypatch.setattr(fs, "generator", lambda seed, device: Key(seed))
    inner_mc, inner_pts = engine.masks_and_centers, refine.sample_fgbg_points
    inner_seed, inner_debug = AttnShiftDetector.seed_pseudo_gt, AttnShiftDetector.seed_debug

    def masks_and_centers(cams, vit_feat, boxes, pts, *args, generator=None,
                          points_override=None, gumbel=None, **kw):
        if isinstance(generator, Key):
            k_refine, k_points = jax.random.split(jax.random.PRNGKey(generator.seed))
            if points_override is None:
                pfg, pbg = jsample(k_refine, norm_attns(jnp.asarray(cams.numpy())),
                                   jnp.asarray(pts.numpy()), 0.2, 0.1, 20,
                                   stride=kw.get("map_stride", 1))
                points_override = (torch.from_numpy(np.array(pfg)),
                                   torch.from_numpy(np.array(pbg)))
            gumbel = gumbel_noise(k_points, cams.shape[0], cams.shape[1] * cams.shape[2])
            generator = None
        return inner_mc(cams, vit_feat, boxes, pts, *args, generator=generator,
                        points_override=points_override, gumbel=gumbel, **kw)

    def sample_fgbg_points(attn_norm, gt_points, thr_pos=0.2, thr_neg=0.1, num_points=20,
                           stride=1, generator=None):
        if isinstance(generator, Key):
            pfg, pbg = jsample(jax.random.PRNGKey(generator.seed), jnp.asarray(attn_norm.numpy()),
                               jnp.asarray(gt_points.numpy()), thr_pos, thr_neg, num_points,
                               stride=stride)
            return torch.from_numpy(np.array(pfg)), torch.from_numpy(np.array(pbg))
        return inner_pts(attn_norm, gt_points, thr_pos, thr_neg, num_points, stride, generator)

    def seed_pseudo_gt(self, img, pts, lbl, val, wh, generator=None, draws=None):
        if isinstance(generator, Key):
            from test_torch_diagnosis import narrow_jax_detector

            dbg = inner_debug(self, img, pts, lbl, val, wh)
            h, w = img.shape[1:3]
            draws = replay_draws(narrow_jax_detector(), variables,
                                 {"best_cams": dbg["best_cams"].numpy()},
                                 jax.random.PRNGKey(generator.seed), pts.numpy(),
                                 self.seed_map_stride, (h, w))
            generator = None
        return inner_seed(self, img, pts, lbl, val, wh, generator=generator, draws=draws)

    def seed_debug(self, *args, generator=None, draws=None):
        # the study reads only Stage A and the MIL choice of seed_debug
        return inner_debug(self, *args, generator=None if isinstance(generator, Key) else generator,
                           draws=draws)

    monkeypatch.setattr(engine, "masks_and_centers", masks_and_centers)
    monkeypatch.setattr(refine, "sample_fgbg_points", sample_fgbg_points)
    monkeypatch.setattr(AttnShiftDetector, "seed_pseudo_gt", seed_pseudo_gt)
    monkeypatch.setattr(AttnShiftDetector, "seed_debug", seed_debug)


# ---------------------------------------------------------------- the study


@pytest.fixture
def jitted_jax_engine(monkeypatch):
    """The JAX engine's ``masks_and_centers`` jitted (the JAX tool calls it
    op by op: ~80 s for the constructed scenes), keeping the outputs of
    every call made outside a trace."""
    from attentionshift_tpu.pseudo import engine as jengine

    calls = []
    fn = jax.jit(jengine.masks_and_centers, static_argnames=("map_stride", "img_hw"))

    def run(*args, **kw):
        out = fn(*args, **kw)
        if not any(isinstance(x, jax.core.Tracer) for x in jax.tree.leaves(out)):
            calls.append(jax.tree.map(np.asarray, out))
        return out

    monkeypatch.setattr(jengine, "masks_and_centers", run)
    return calls


def stage_c_agrees(a, b, rel: float = 1e-5) -> bool:
    """Two ``masks_and_centers`` outputs: the refined maps within 1e-4 and
    the semantic centers' validity equal, their coordinates within
    ``rel`` of the image size."""
    fa, fb = np.asarray(a.map_fg), np.asarray(b.map_fg)
    va, vb = np.asarray(a.centers.part_valid), np.asarray(b.centers.part_valid)
    ca, cb = np.asarray(a.centers.coords), np.asarray(b.centers.coords)
    return (np.abs(fa - fb).max() <= 1e-4 and np.array_equal(va, vb)
            and np.abs(np.where(va[..., None], ca - cb, 0.0)).max() <= rel * 256)


def reordered(inner, args, kw, seed: int):
    """``masks_and_centers`` on the same inputs with the feature channels
    permuted: the same mathematics (cosines, prototype means and center
    coordinates do not depend on the order of the channels), every sum
    over them taken in another order."""
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(args[1].shape[0]))
    return inner(args[0], args[1][perm], *args[2:], **kw)


def test_synthetic_center_drift_against_the_jax_tool(tmp_path, monkeypatch, jitted_jax_engine):
    """``synthetic_center_drift`` (16 constructed scenes, stride 4 and 1,
    key 11 replayed) at 256 x 256, call by call against the JAX tool. The
    scenes are near-degenerate on purpose (every background feature is one
    direction plus 5 % noise), so Stage B's winner-take-all can sit on a
    tie that f32 summation order decides (ROADMAP section C, "Stage-B
    near-ties"). Each call must equal the JAX call (refined maps within
    1e-4, centers' validity equal, coordinates within 1e-5 of the image
    size) as it is or, where it does not, under one of up to 8 orders of
    the feature channels' sums (``reordered``): the difference is then one
    of summation order, and such calls are counted. Without any such call
    the reports, unrounded, agree to 1e-5 relative."""
    from attentionshift_torch.pseudo import engine

    ns = jax_study(str(tmp_path / "fidelity_study.py"), H=256, W=256)
    unrounded(ns, monkeypatch)
    unrounded(fs, monkeypatch)
    replay(monkeypatch)
    mine, inner = [], engine.masks_and_centers

    def record(*args, **kw):
        out = inner(*args, **kw)
        mine.append((args, kw, out))
        return out

    monkeypatch.setattr(engine, "masks_and_centers", record)
    want = ns["synthetic_center_drift"]()
    got = fs.synthetic_center_drift((256, 256), torch.device("cpu"))
    assert len(mine) == len(jitted_jax_engine) == 32
    reorder = []
    for i, ((args, kw, out), ref) in enumerate(zip(mine, jitted_jax_engine)):
        if stage_c_agrees(out, ref):
            continue
        assert any(stage_c_agrees(reordered(inner, args, kw, s), ref) for s in range(8)), \
            f"call {i} differs from JAX under every order of the channel sums"
        reorder.append(i)
    assert len(reorder) < len(mine) // 2, reorder
    if not reorder:
        close_report(got, want, 1e-5)
    assert got["n_pairs"] > 0 and got["exact_centers_per_instance"] > 0


def test_sampling_ratio_table_equals_the_jax_tools(monkeypatch):
    """The RoIAlign sampling-ratio table on the smooth features, without
    its rounding, against the JAX tool's lines (run here: the JAX tool
    computes it inside ``main``), within 1e-5 relative."""
    from attentionshift_tpu.ops.image import resize as jresize
    from attentionshift_tpu.ops.roi_align import roi_align as jroi_align

    unrounded(fs, monkeypatch)
    lowres = np.random.RandomState(1).randn(1, 384, 8, 8).astype(np.float32)
    feat = np.asarray(jresize(jnp.asarray(lowres[0]), (32, 32)))[None]
    boxes = np.asarray([[0, 10.0, 10.0, 300.0, 200.0], [0, 50.0, 80.0, 120.0, 140.0],
                        [0, 0.0, 0.0, 511.0, 511.0]], np.float32)
    outs = {sr: np.asarray(jroi_align(jnp.asarray(feat), jnp.asarray(boxes), 1.0 / 16.0,
                                      output_size=7, sampling_ratio=sr)) for sr in (1, 2, 4, 8)}
    scale = np.abs(outs[8]).mean() + 1e-9
    want = {sr: dict(mean=float(np.abs(outs[sr] - outs[8]).mean() / scale),
                     max=float(np.abs(outs[sr] - outs[8]).max() / scale)) for sr in (1, 2, 4)}
    got = fs.roi_align_sr_error(torch.device("cpu"))
    close_report(got, want, 1e-5)
    assert 0 < got[4]["mean"] < got[2]["mean"] < got[1]["mean"]


class NarrowJaxDetector:
    """``AttnShiftDetector`` as the JAX tool's namespace uses it: called, the
    narrow model; its methods, the class's."""

    from attentionshift_tpu.models.detector import AttnShiftDetector as _cls

    seed_pseudo_gt, seed_debug = _cls.seed_pseudo_gt, _cls.seed_debug

    def __new__(cls, **kw):
        from test_torch_diagnosis import narrow_jax_detector

        return narrow_jax_detector(**kw)


def test_study_matches_the_jax_tool_end_to_end(tmp_path, monkeypatch, capsys):
    """``main --ckpt --eval-images 1 --eval-size 256 256`` of both tools on
    seeded random weights of the narrow model (``random_variables``; an
    orbax export for the JAX tool, a ``save_params`` export for the twin),
    every draw replayed: the whole
    report (end to end, noise floor, isolated stride with the stable
    subset, the RoIAlign table) within one unit of its last printed digit
    (1e-4, the tools round to 4-5 places), the provenance aside (it names
    each side's file); the constructed-feature drift is stubbed on both
    sides (its near-degenerate scenes are held call by call in
    ``test_synthetic_center_drift_against_the_jax_tool``). The JAX tool's
    ``FIDELITY.md`` goes to ``tmp_path``."""
    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.train import save_params
    from attentionshift_tpu.train.checkpoint import save_params as jsave
    from test_torch_diagnosis import narrow_jax_detector

    tools = tmp_path / "tools" / "analysis"
    tools.mkdir(parents=True)
    args = (np.zeros((1, 64, 64, 3), np.float32), np.zeros((1, 8, 2), np.float32),
            np.zeros((1, 8), np.int32), np.zeros((1, 8), bool), np.asarray([[64.0, 64.0]]))
    variables = jax.tree.map(np.asarray, random_variables(narrow_jax_detector(), args))
    jdir, pfile = tmp_path / "jax_params", tmp_path / "params.pt"
    jsave(str(jdir), variables)
    save_params(str(pfile), flax_to_torch(variables))

    ns = jax_study(str(tools / "fidelity_study.py"))
    ns["BASE"] = dict(ns["BASE"], **NARROW)
    ns["AttnShiftDetector"] = NarrowJaxDetector
    # held call by call in its own test; here only its place in the report
    stub = lambda *a: dict(center_drift_px=dict(p50=None, p90=None, p100=None),  # noqa: E731
                           exact_centers_per_instance=0.0, fast_center_in_fg_frac=None, n_pairs=0)
    ns["synthetic_center_drift"] = stub
    monkeypatch.setattr(fs, "synthetic_center_drift", stub)
    argv = ["--eval-images", "1", "--eval-size", "256", "256"]
    monkeypatch.setattr(sys, "argv", ["fidelity_study", "--ckpt", str(jdir), *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ns["main"]()
    want = json.loads([x for x in buf.getvalue().splitlines() if x.startswith("{")][-1])
    assert (tmp_path / "FIDELITY.md").exists()

    monkeypatch.setattr(fs, "BASE", dict(fs.BASE, **NARROW))
    replay(monkeypatch, variables)
    out = tmp_path / "report.md"
    got = fs.main(["--ckpt", str(pfile), *argv, "--out", str(out), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-2]) == json.loads(json.dumps(got))
    for k in ("params_provenance",):
        assert got.pop(k).startswith("checkpoint") and want.pop(k).startswith("checkpoint")
    assert {k: got.pop(k) for k in ("device", "dtype")} == dict(device="cpu", dtype="float32")
    close_report(json.loads(json.dumps(got)), want, 1e-4)
    assert got["end_to_end"]["n"] == 2 and got["isolated_stride"]["n"] == 2
    assert out.read_text().startswith("# FIDELITY") and "```json" in out.read_text()
    drop_weights(pfile)
    import shutil

    shutil.rmtree(jdir, ignore_errors=True)


def test_main_trains_and_writes_only_where_asked(tmp_path, monkeypatch, capsys):
    """One inline train step and one image on the CPU, with ``--count-cut``:
    the report has the JAX tool's keys and the cut planes per CCL
    configuration (none cut at these sizes); the markdown goes to
    ``--out`` and nowhere else (the directory holds that file only, and
    ``FIDELITY.md`` is unchanged: the module fixture)."""
    monkeypatch.setattr(fs, "BASE", dict(fs.BASE, **NARROW))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "study.md"
    rep = fs.main(["--train-steps", "1", "--train-images", "1", "--eval-images", "1",
                   "--eval-size", "256", "256", "--out", str(out), "--count-cut",
                   "--device", "cpu"])
    assert os.listdir(tmp_path) == ["study.md"]
    text = out.read_text()
    assert "| end-to-end |" in text and "CCL planes cut by the sweep cap" in text
    assert set(rep) >= {"params_provenance", "train_steps", "eval_images", "end_to_end",
                        "sampling_noise_floor", "isolated_stride",
                        "synthetic_feature_center_drift", "roi_align_sr_rel_err_vs_sr8"}
    assert rep["params_provenance"] == "1 inline train steps" and rep["train_steps"] == 1
    cut = rep["ccl_planes_cut"]
    assert set(cut) == {"16x16 cap 64", "32x32 cap 64", "256x256 cap 256"}
    assert all(c == 0 and n > 0 for c, n in cut.values())
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("trained 1 steps in ") and lines[-1] == f"wrote {out}"


def test_count_cut_sees_a_cut_plane():
    """The control of ``counting_cut_planes``: a spiral-free snake of one
    pixel wide needs many sweeps, so at a cap of 1 sweep its plane is cut,
    and a single dot is not."""
    from attentionshift_torch.pseudo import engine

    snake = torch.zeros(1, 16, 16, dtype=torch.bool)
    for r in range(0, 16, 2):
        snake[0, r] = True
        snake[0, r + 1, 15 if (r // 2) % 2 == 0 else 0] = r + 1 < 16
    dot = torch.zeros(1, 16, 16, dtype=torch.bool)
    dot[0, 3, 3] = True
    store = {}
    with fs.counting_cut_planes(store):
        engine.connected_components_batch(torch.cat([snake, dot]), max_iters=1)
    assert store == {((16, 16), 1): (1, 2)}
    assert engine.connected_components_batch.__module__ == "attentionshift_torch.ops.ccl"
