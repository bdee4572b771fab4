"""The profiling twins, ``trace_ops``, ``warm_cache`` and the port's import
guard, on the CPU.

The JAX profiling scripts (``tools/analysis/profile_*.py``,
``calibrate_overhead.py``) do their work when imported, at the benchmark's
4301 tokens, so they are read, never imported: their labels come from
their source (each ``bench(..., name=...)`` and each label printed by
hand, f-strings evaluated with the script's own constants), and their
seeded inputs from their module-level assignments run with small
constants (the ``bench`` calls left out). Each twin runs once at a tiny
shape on the CPU: it prints the JAX tool's labels in the JAX tool's order
with a finite time each; its inputs equal the JAX tool's (bitwise, after
the same rounding to bf16; the softmax maps of ``profile_stage_a`` within
one bf16 step, JAX's f32 softmax against torch's); what it timed equals
the port's module functions on the same inputs (exactly: the same calls).
"""

from __future__ import annotations

import ast
import gzip
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from attentionshift_torch.tools import warm_cache  # noqa: E402
from attentionshift_torch.tools.analysis import (  # noqa: E402
    calibrate_overhead, profile_backbone, profile_seed, profile_stage_a, profile_stage_bc, trace_ops)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def source(rel: str) -> ast.Module:
    with open(os.path.join(REPO, rel)) as f:
        return ast.parse(f.read())


def constants(tree: ast.Module, **override) -> dict:
    """The module-level assignments of plain numbers (and arithmetic on
    them) of a JAX script, in order; the names of ``override`` take its
    values right after their own assignment, so the later ones derive
    from them."""
    ns: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and all(
                isinstance(n, (ast.Constant, ast.Name, ast.BinOp, ast.Tuple, ast.operator,
                               ast.Load, ast.Store))
                for n in ast.walk(node.value)):
            exec(compile(ast.Module(body=[node], type_ignores=[]), "<const>", "exec"), ns)
            ns.update({k: v for k, v in override.items() if k in ns})
    return ns


def jax_labels(rel: str, **override) -> list:
    """The labels a JAX profiling script prints, in order: the ``name=`` of
    each ``bench`` call (f-strings with the script's constants, or with
    ``override``) and the string literal that opens each hand-printed
    f-string label."""
    tree = source(rel)
    ns = constants(tree, **override)
    labels = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "bench":
            for kw in node.keywords:
                if kw.arg == "name":
                    labels.append((node.lineno, eval(compile(ast.Expression(kw.value), rel, "eval"), ns)))
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
              and node.args and isinstance(node.args[0], ast.JoinedStr)):
            first = node.args[0].values[0]
            if isinstance(first, ast.FormattedValue) and isinstance(first.value, ast.Constant):
                labels.append((node.lineno, first.value.value))
    return [label for _, label in sorted(labels)]


def printed(out: str, width: int) -> list:
    """(label, ms) of each table line of a twin."""
    rows = []
    for line in out.splitlines():
        m = re.match(rf"^(.{{{width}}}) +(-?[0-9.]+) ms", line)
        if m:
            rows.append((m.group(1).rstrip(), float(m.group(2))))
    return rows


def jax_inputs(rel: str, **small) -> dict:
    """The module-level assignments of a JAX profiling script, run with its
    size constants replaced by ``small``; the statements that call
    ``bench`` are left out."""
    tree = source(rel)
    body = []
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        calls = {getattr(n.func, "id", None) for n in ast.walk(node) if isinstance(n, ast.Call)}
        if "bench" in calls:
            continue
        body.append(node)
    ns = dict(np=np, jax=jax, jnp=jnp)
    for node in body:
        exec(compile(ast.Module(body=[node], type_ignores=[]), rel, "exec"), ns)
        names = {t.id for tgt in node.targets for t in ast.walk(tgt) if isinstance(t, ast.Name)}
        if names & set(small):  # the size line: take the small sizes, then go on
            ns.update(small)
            for other in body[body.index(node) + 1:]:
                exec(compile(ast.Module(body=[other], type_ignores=[]), rel, "exec"), ns)
            return ns
    raise AssertionError(f"{rel}: no assignment of {sorted(small)}")


def same(a, b) -> bool:
    a = a.float().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(jnp.asarray(b).astype(jnp.float32)) if hasattr(b, "dtype") else np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.float64), b.astype(np.float64))


def test_labels_at_the_defaults_are_the_jax_tools():
    """Every twin's labels at its default sizes, against the JAX script's
    (read from its source). One difference, in the JAX label's arithmetic:
    ``calibrate_overhead``'s second product is 2 x 4352^2 x 384 = 14.546e9
    flops, which the JAX label prints as 14.6 GF and the twin as 14.5."""
    assert jax_labels("tools/analysis/profile_seed.py") == list(profile_seed.LABELS)
    assert jax_labels("tools/analysis/profile_backbone.py") == [n for n, _ in profile_backbone.LAYERS]
    assert jax_labels("tools/analysis/profile_stage_a.py") == profile_stage_a.labels(
        profile_stage_a.parse_args([]))
    assert jax_labels("tools/analysis/profile_stage_bc.py") == list(profile_stage_bc.LABELS)
    want = jax_labels("tools/analysis/calibrate_overhead.py")
    got = calibrate_overhead.labels(calibrate_overhead.parse_args([]))
    assert got[:-1] == want[:-1]
    assert (want[-1], got[-1]) == ("matmul 4352x4352x384 (14.6 GF)", "matmul 4352x4352x384 (14.5 GF)")


def test_profile_seed_on_cpu(capsys):
    """64 x 64, ``max_gt`` 8, f32: the five lines in the JAX tool's order,
    the three timed ones positive and the two stages their differences;
    the inputs are the JAX tool's draws; the full call's outputs equal
    ``seed_pseudo_gt`` with a generator seeded 5, and Stage A's pseudo
    boxes equal the full call's."""
    args = ["--height", "64", "--width", "64", "--max-gt", "8", "--steps", "1",
            "--dtype", "float32", "--device", "cpu"]
    res = profile_seed.main(args)
    rows = printed(capsys.readouterr().out, profile_seed.WIDTH)
    assert [r[0] for r in rows] == list(profile_seed.LABELS)
    t = res["times"]
    assert all(np.isfinite(ms) and ms > 0 for _, ms in rows[:3])
    assert t[profile_seed.LABELS[3]] == t[profile_seed.LABELS[1]] - t[profile_seed.LABELS[0]]
    assert t[profile_seed.LABELS[4]] == t[profile_seed.LABELS[2]] - t[profile_seed.LABELS[1]]
    inp = profile_seed.make_inputs(64, 64, 8, torch.device("cpu"))
    h = w = 64
    assert same(inp[0], np.random.RandomState(0).randn(1, h, w, 3).astype(np.float32))
    assert same(inp[1], (np.random.RandomState(1).rand(1, 8, 2) * [w * 0.9, h * 0.9] + 10)
                .astype(np.float32))
    assert same(inp[2], np.random.RandomState(2).randint(0, 20, (1, 8)))
    assert inp[3].tolist() == [[True] * 8]
    model = profile_seed.build_model(profile_seed.parse_args(args), torch.device("cpu"))
    want = model.seed_pseudo_gt(*inp, generator=torch.Generator().manual_seed(5))
    full = res["outputs"][profile_seed.LABELS[2]]
    assert set(full) == set(want) and all(torch.equal(full[k], want[k]) for k in want)
    assert torch.equal(res["outputs"][profile_seed.LABELS[1]]["pseudo_boxes"],
                       want["pseudo_gt_bboxes"])


def test_profile_backbone_on_cpu(capsys):
    """(1, 6, 64, 64) bf16: the three lines with their ms/layer column; q, k,
    v, x and the four weights bitwise the JAX tool's; the loops' outputs
    equal the capture and plain attention chained by hand."""
    from attentionshift_torch.ops.attention import attention_no_capture, attention_with_capture

    res = profile_backbone.main(["--tokens", "64", "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    rows = printed(out, profile_backbone.WIDTH)
    assert [r[0] for r in rows] == [n for n, _ in profile_backbone.LAYERS]
    assert all(np.isfinite(ms) and ms > 0 for _, ms in rows)
    assert len(re.findall(r"ms/layer\)", out)) == 3
    ns = jax_inputs("tools/analysis/profile_backbone.py", B=1, H_=6, T=64, D=64, E=384)
    inp = res["inputs"]
    for name in ("q", "k", "v", "x", "w_qkv", "w_proj", "w_fc1", "w_fc2"):
        assert same(inp[name], ns[name]), name
    o, acc = inp["q"], torch.zeros((1, 64, 64), dtype=torch.bfloat16)
    for _ in range(7):
        o, m = attention_with_capture(o, inp["k"], inp["v"])
        acc = acc + m
    got_o, got_acc = res["outputs"][profile_backbone.LAYERS[0][0]]
    assert torch.equal(got_o, o) and torch.equal(got_acc, acc)
    o = inp["q"]
    for _ in range(5):
        o = attention_no_capture(o, inp["k"], inp["v"])
    assert torch.equal(res["outputs"][profile_backbone.LAYERS[1][0]], o)


def test_profile_stage_a_on_cpu(capsys):
    """64 x 96, ``max_gt`` 4, 3 layers, 10 points: the three lines with the
    JAX tool's labels at these sizes; the inputs the JAX tool's; the
    candidate boxes equal ``candidate_boxes`` on the timed rollout rows."""
    from attentionshift_torch.pseudo.engine import candidate_boxes

    argv = ["--height", "64", "--width", "96", "--max-gt", "4", "--dim", "32", "--points", "10",
            "--layers", "3", "--steps", "1", "--device", "cpu"]
    res = profile_stage_a.main(argv)
    rows = printed(capsys.readouterr().out, profile_stage_a.WIDTH)
    args = profile_stage_a.parse_args(argv)
    ns = jax_inputs("tools/analysis/profile_stage_a.py", H=64, W=96, G=4, D=32, P=10, L=3)
    assert [r[0] for r in rows] == profile_stage_a.labels(args) == jax_labels(
        "tools/analysis/profile_stage_a.py", H=64, W=96, G=4, D=32, P=10, L=3)
    assert all(np.isfinite(ms) and ms > 0 for _, ms in rows)
    inp = res["inputs"]
    diff = (inp["attns"].float().numpy() - np.asarray(ns["attns"].astype(jnp.float32)))
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(np.asarray(ns["attns"].astype(jnp.float32))), 1e-30))) - 7)
    assert (np.abs(diff) <= step).all()
    for name, jname in (("tok", "tok"), ("gt_points", "gt_points"), ("roi_map", "roi_map")):
        assert same(inp[name], ns[jname]), name
    assert same(inp["rois"][:, 1:], ns["cand"]) and not inp["rois"][:, 0].any()
    rows_out = res["outputs"][rows[0][0]]
    want = candidate_boxes(rows_out[:, 0], inp["tok"], inp["gt_points"], (4, 6), (64, 96),
                           cam_stride=8, ccl_iters=64)
    got = res["outputs"][rows[1][0]]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_profile_stage_bc_on_cpu(capsys):
    """64 x 96, ``max_gt`` 8: the four lines in order; the inputs bitwise the
    JAX tool's; the semantic centers equal ``semantic_centers`` on the
    timed maps."""
    from attentionshift_torch.pseudo.meanshift import semantic_centers

    res = profile_stage_bc.main(["--height", "64", "--width", "96", "--max-gt", "8", "--dim", "32",
                                 "--steps", "1", "--device", "cpu"])
    rows = printed(capsys.readouterr().out, profile_stage_bc.WIDTH)
    assert [r[0] for r in rows] == list(profile_stage_bc.LABELS)
    assert all(np.isfinite(ms) and ms > 0 for _, ms in rows)
    ns = jax_inputs("tools/analysis/profile_stage_bc.py", H=64, W=96, G=8, D=32)
    inp = res["inputs"]
    for name in ("cams_patch", "vit_feat", "boxes", "gt_points", "gt_labels", "valid"):
        assert same(inp[name], ns[name]), name
    maps = res["outputs"][profile_stage_bc.LABELS[1]]
    want = semantic_centers(maps.map_fg, maps.map_bg, inp["boxes"], inp["vit_feat"],
                            inp["gt_labels"], inp["valid"], pos_thr=0.35, n_shift=10,
                            num_semantic_points=5)
    got = res["outputs"][profile_stage_bc.LABELS[3]]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_calibrate_overhead_on_cpu(capsys):
    """Small sizes: the seven lines in the JAX tool's order (its labels at
    these sizes), three decimals, finite positive times."""
    argv = ["--instances", "4", "--height", "64", "--width", "96", "--tokens", "64", "--dim", "32",
            "--steps", "2", "--device", "cpu"]
    res = calibrate_overhead.main(argv)
    out = capsys.readouterr().out
    rows = printed(out, calibrate_overhead.WIDTH)
    assert [r[0] for r in rows] == calibrate_overhead.labels(calibrate_overhead.parse_args(argv))
    # the JAX labels name the sizes literally: at the defaults they are the
    # twin's (test_labels_at_the_defaults_are_the_jax_tools)
    assert list(res["times"]) == [r[0] for r in rows]
    assert all(np.isfinite(ms) and ms > 0 for _, ms in rows)
    assert all(re.search(r" \d+\.\d{3} ms$", line) for line in out.splitlines())


@pytest.mark.parametrize("tool, argv", [
    (profile_seed, []), (profile_backbone, []), (profile_stage_a, []), (profile_stage_bc, []),
    (calibrate_overhead, []), ("diagnose_det", []), ("probe_rpn", []), ("fidelity_study", []),
    (warm_cache, []), (profile_seed, ["--device", "cuda"]),
])
def test_the_card_is_asked_for_and_nothing_falls_back(tool, argv, monkeypatch):
    """Without ``--device`` (or with ``cuda``) each twin asks for the card
    and, this machine having none, raises before it builds or runs
    anything on the CPU."""
    import importlib

    from attentionshift_torch import models

    if isinstance(tool, str):
        tool = importlib.import_module(f"attentionshift_torch.tools.analysis.{tool}")
    monkeypatch.setattr(models, "AttnShiftDetector", lambda *a, **k: pytest.fail("built"))
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tool.main(argv)


# ----------------------------------------------------------------- trace_ops


@pytest.fixture
def cpu_trace(tmp_path):
    """A ``torch.profiler`` trace of a few CPU ops (a kernel called twice
    at two shapes), exported as Chrome json under ``tmp_path/run``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for n in (32, 64):
            x = torch.randn(n, n)
            torch.relu(x @ x).sum()
    d = tmp_path / "run" / "step"
    d.mkdir(parents=True)
    path = d / "trace.json"
    prof.export_chrome_trace(str(path))
    return path


def test_trace_ops_sums_the_lane(cpu_trace, capsys):
    """The CPU lane (``--device cpu``) of the trace, found by a recursive
    search of its directory: merged and ``--no-merge``, the total and each
    row equal a direct sum of the trace's ``cpu_op`` events; the printed
    header counts them; the same totals from a ``.json.gz`` copy."""
    with open(cpu_trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    direct = {}
    for e in events:
        direct[e["name"]] = direct.get(e["name"], 0.0) + e.get("dur", 0)
    root = str(cpu_trace.parent.parent)
    raw = trace_ops.main([root, "--no-merge", "--device", "cpu", "--top", "100"])
    assert raw["n_events"] == len(events) and raw["lane"] == "cpu_op"
    assert raw["per_op"].keys() == direct.keys()
    assert all(abs(raw["per_op"][k] - v) < 1e-6 for k, v in direct.items())
    merged = trace_ops.main([root, "--device", "cpu"])
    assert abs(sum(merged["per_op"].values()) - sum(direct.values())) < 1e-6
    out = capsys.readouterr().out
    assert f"{len(events)} cpu_op events, total time {sum(direct.values()) / 1e3:.3f} ms" in out
    assert "aten::relu" in merged["per_op"] and "aten::mm" in merged["per_op"]
    gz = cpu_trace.parent / "trace.json.gz"
    with open(cpu_trace, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    cpu_trace.unlink()
    again = trace_ops.main([str(gz), "--no-merge", "--lane", "cpu_op"])
    assert again["per_op"] == raw["per_op"]


def test_trace_ops_merges_instances_and_refuses_an_empty_lane(cpu_trace):
    """Kernel names that differ in template arguments, argument lists or a
    numeric suffix fold into one row; the CUDA lane of a CPU trace holds
    no event, and the tool says so instead of printing an empty table."""
    assert trace_ops.merged_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
        "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)"
    ) == "void at::native::vectorized_elementwise_kernel"
    assert trace_ops.merged_name("(anonymous namespace)::flash_fwd<64>(CUtensorMap, int)") == \
        "(anonymous namespace)::flash_fwd"
    assert trace_ops.merged_name("fusion.123") == "fusion"
    with pytest.raises(SystemExit, match="no 'kernel' events"):
        trace_ops.main([str(cpu_trace)])


# ---------------------------------------------------------------- warm_cache


def test_warm_cache_without_nvcc_claims_no_build(tmp_path, monkeypatch, capsys):
    """Asked for the card's kernels where no ``nvcc`` exists (this machine:
    the card is faked, ``PATH`` and ``CUDA_HOME`` hold no toolchain), the
    tool raises before it reports anything, and builds nothing."""
    from attentionshift_torch import device
    from attentionshift_torch.ops import _build

    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        warm_cache.main([])
    assert "[warm_cache]" not in capsys.readouterr().out
    assert not (tmp_path / "build").exists()


def test_warm_cache_builds_the_mask_api_on_cpu(tmp_path, monkeypatch, capsys):
    """``--device cpu`` builds only ``native/maskapi.cpp`` (g++), into the
    build directory: "built" the first time, "cached" the second."""
    from attentionshift_torch import native

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    first = warm_cache.main(["--device", "cpu"])
    again = warm_cache.main(["--device", "cpu"])
    assert [(os.path.dirname(p), c) for p, c, _ in first] == [(str(tmp_path), False)]
    assert [(p, c) for p, c, _ in again] == [(first[0][0], True)] and os.path.exists(first[0][0])
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[warm_cache] maskapi")]
    assert [x.split()[2] for x in lines] == ["built", "cached"]


# ------------------------------------------------------------------- guard

GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "attentionshift_tpu", "tools")

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
for name in REFUSED:
    try:
        importlib.import_module(name)
    except ImportError:
        pass
    else:
        raise SystemExit(f"the hook let {name} through")
import attentionshift_torch
names = sorted(m.name for m in pkgutil.walk_packages(attentionshift_torch.__path__, "attentionshift_torch."))
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
print(len(names), leaked)
"""


def test_every_port_module_imports_without_jax_or_the_reference():
    """Every module of ``attentionshift_torch`` (the new tools included),
    imported in a fresh interpreter whose import hook refuses ``jax``,
    ``flax``, ``optax``, ``orbax``, ``attentionshift_tpu`` and the
    repository's top-level ``tools``; the hook's control: each refused
    name fails to import there."""
    r = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    count, leaked = r.stdout.strip().split(" ", 1)
    assert leaked == "[]"
    import pkgutil

    import attentionshift_torch

    names = [m.name for m in pkgutil.walk_packages(attentionshift_torch.__path__,
                                                   "attentionshift_torch.")]
    assert int(count) == len(names) > 100
    assert {"attentionshift_torch.tools.analysis.profile_seed",
            "attentionshift_torch.tools.analysis.fidelity_study",
            "attentionshift_torch.tools.warm_cache"} <= set(names)
