"""The training entry point of the port and what it needs.

- the MAE graft (``models/convert.py``) against the JAX package's on the
  same ``torch.save``d state dict, loaded by both packages through a
  ``file://`` URL: copied tensors exactly, a resized pos-embed grid to 1e-6;
- ``utils/``: the metric logger's lines and jsonl records, and the
  non-finite loss guards, against the JAX twins;
- ``python -m attentionshift_torch.tools.train`` in this process on the
  CPU at a TINY width over a synthetic point tree: its files, its raises,
  a run resumed from ``epoch_1`` ending bitwise equal to an unbroken run,
  its first step against the JAX train step on the same weights, batch and
  draws;
- the train variants through the CLI on the CPU: the EMA-teacher config
  (its teacher moved by the step, left out of the checkpoint, rebuilt
  from the student on resume) and the COCO config with its RepPoints
  cascade, at TINY width;
- the layer-decay rule: the JAX CLI hands its optimizer the whole
  variables dict (every lr scale 1.0, ``batch_stats`` optimized); the port
  follows ``build_optimizer``'s documented rule over the parameters;
- the ``run_train`` launcher's two commands.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import (ABS_TOL, REPO, TINY, TRAIN_SIZES, check_tree, close,  # noqa: E402
                                coco_tree, disc_tree, drop_weights, jax_model, jax_train_reference,
                                random_variables, torch_tree, voc_tree)

# TINY with the train step's small RPN/RCNN sizes; no drop path and no
# checkpointing where the step is held against JAX (the JAX model runs
# without remat; drop path would need its masks handed in)
MODEL_KW = dict(TINY, max_gt=4, pad_tokens_to=128, drop_path_rate=0.0, **TRAIN_SIZES,
                test_max_per_img=20)
TRAIN_SCALE = (64, 96)
# three landscape images: one bucket, so that every batch is full
TREE = ((64, 96), (64, 96), (64, 96))


def write_config(path, tree: dict, batch_size: int = 2, extra: str = "", **model) -> str:
    """A TINY config over ``tree``: one train scale, the test scale equal,
    one loader thread (batches then do not depend on which decode finishes
    first), 500-step warmup as configured, log every step; ``extra``
    appended as it is."""
    kw = dict(MODEL_KW, use_remat=False, **model)
    path.write_text(f"""
model = dict(**{kw!r})
data = dict(
    train=dict(ann_file={tree['ann_file']!r}, img_prefix={tree['img_prefix']!r}, repeat=1),
    val=dict(split_file={tree['split_file']!r}, voc_root={tree['voc_root']!r}),
    batch_size={batch_size}, num_threads=1, max_gt=4, flip_ratio=0.5,
    train_scales=[{TRAIN_SCALE!r}], test_scale={TRAIN_SCALE!r})
optimizer = dict(base_lr=1e-3, weight_decay=0.05, layer_decay=0.75, accumulate_steps=2,
                 grad_clip=None)
schedule = dict(total_epochs=2, decay_epochs=[8, 11], warmup_iters=2, warmup_ratio=1e-3)
runtime = dict(log_interval=1, checkpoint_interval=1, eval_interval=1, seed=0,
               loss_weight_start_epoch=-1)
{extra}""")
    return str(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Train images of distinct discs (``disc_tree``; see ROADMAP section C
    on Stage-B near-ties with random weights), the val split of
    ``voc_tree``."""
    val = voc_tree(tmp_path_factory.mktemp("VOC2012"))
    return dict(val, **disc_tree(tmp_path_factory.mktemp("discs"), sizes=TREE, seed=1))


# --------------------------------------------------------------- MAE graft


def mae_state(depth: int, d: int, grid: int, seed: int = 0) -> dict:
    """A random MAE encoder state dict (torch tensors, MAE's key names)."""
    rs = np.random.RandomState(seed)
    r = lambda *s: torch.from_numpy((0.02 * rs.randn(*s)).astype(np.float32))  # noqa: E731
    sd = {"patch_embed.proj.weight": r(d, 3, 16, 16), "patch_embed.proj.bias": r(d),
          "cls_token": r(1, 1, d), "pos_embed": r(1, 1 + grid * grid, d),
          "norm.weight": 1.0 + r(d), "mask_token": r(1, 1, d)}
    for i in range(depth):
        for n in ("norm1", "norm2"):
            sd[f"blocks.{i}.{n}.weight"], sd[f"blocks.{i}.{n}.bias"] = 1.0 + r(d), r(d)
        for n, (o, k) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                          ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            sd[f"blocks.{i}.{n}.weight"], sd[f"blocks.{i}.{n}.bias"] = r(o, k), r(o)
    return sd


@pytest.mark.parametrize("img_size", [224, 128], ids=["same-grid", "resized-14-to-8"])
def test_mae_graft_matches_jax(tmp_path, monkeypatch, img_size):
    """Both packages load one ``torch.save``d MAE state dict through a
    ``file://`` URL (each into its own cache, keyed by the URL's digest) and
    graft it onto the same TINY backbone: every copied tensor equal exactly
    through the port's layout (the patch projection's (p, p, C) order), the
    pos embed of a 14x14 grid resized to the model's 8x8 within 1e-6, every
    key that MAE lacks at its init."""
    from attentionshift_torch.models.convert import load_torch_state_dict, mae_to_vit_params
    from attentionshift_tpu.models.convert import load_torch_state_dict as jload
    from attentionshift_tpu.models.convert import mae_to_vit_params as jgraft

    from attentionshift_torch.convert import flax_to_torch
    from test_torch_support import inputs, torch_model

    sd = mae_state(TINY["depth"], TINY["embed_dim"], grid=14)
    path = tmp_path / "mae_pretrain_vit_tiny.pth"
    torch.save({"model": sd}, path)
    url = path.as_uri()
    monkeypatch.setenv("ATTNSHIFT_CKPT_CACHE", str(tmp_path / "jax_cache"))
    jstate = jload(url)
    monkeypatch.setenv("ATTNSHIFT_CKPT_CACHE", str(tmp_path / "port_cache"))
    state = load_torch_state_dict(url)
    assert len(list((tmp_path / "jax_cache").iterdir())) == 1
    assert len(list((tmp_path / "port_cache").iterdir())) == 1
    assert set(state) == set(jstate) == set(sd)

    kw = dict(TINY, img_size=img_size)
    jm = jax_model(**kw)
    variables = random_variables(jm, inputs(64, 96, 4, 3))
    grafted = jgraft(jstate, variables["params"]["backbone"], depth=TINY["depth"])
    want = {k[len("backbone."):]: v for k, v in
            flax_to_torch({"params": {"backbone": grafted},
                           "batch_stats": variables["batch_stats"]}).items()}
    port = torch_model(variables, **kw)
    init = {k: v.clone() for k, v in port.backbone.state_dict().items()}
    got = mae_to_vit_params(state, port.backbone.state_dict(), depth=TINY["depth"])
    assert set(got) == set(want) == set(init)
    assert all(torch.equal(a, b) for a, b in zip(port.backbone.state_dict().values(),
                                                   init.values())), "the input was modified"
    copied = {k for k in sd if k.startswith(("blocks.", "patch_embed.", "cls_token"))}
    for k in got:
        if k == "pos_embed":
            assert got[k].shape == (1, 1 + (img_size // 16) ** 2, TINY["embed_dim"])
            if img_size == 224:
                assert torch.equal(got[k], sd[k])
            else:
                close(got[k].numpy(), want[k].numpy(), 1e-6, what=k)
        elif k in copied:
            ref = sd[k].permute(0, 2, 3, 1).reshape(sd[k].shape[0], -1) if k == "patch_embed.proj.weight" else sd[k]
            assert torch.equal(got[k], ref), k
            assert torch.equal(got[k], want[k]), k
        else:  # point tokens, point pos embed, FPN taps, point heads
            assert torch.equal(got[k], init[k]), k
            assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------------- utils


def test_metric_logger_matches_jax(tmp_path):
    """The same metric stream through both ``MetricLogger``s (window 3):
    equal console lines once the time field is masked, equal jsonl records."""
    from attentionshift_torch.utils import MetricLogger
    from attentionshift_tpu.utils import MetricLogger as JLogger

    rs = np.random.RandomState(0)
    ours, theirs = MetricLogger(str(tmp_path / "a.jsonl"), 3), JLogger(str(tmp_path / "b.jsonl"), 3)
    mask = lambda line: re.sub(r"time: [0-9.]+", "time: T", line)  # noqa: E731
    for it in range(6):
        m = {"loss_cls": float(rs.rand()), "acc": float(100 * rs.rand()), "loss_total": float(it)}
        ours.update(m)
        theirs.update(m)  # both CLIs hand their loggers plain floats
        lr = None if it % 2 else 1e-4 * it
        assert mask(ours.line(1, it, 6, lr=lr)) == mask(theirs.line(1, it, 6, lr=lr))
    a = [json.loads(x) for x in (tmp_path / "a.jsonl").read_text().splitlines()]
    b = [json.loads(x) for x in (tmp_path / "b.jsonl").read_text().splitlines()]
    assert a == b and len(a) == 6


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_loss_guards_match_jax(bad):
    """``check_finite_losses`` raises the same error in both packages for a
    non-finite term and passes finite ones; ``guard_losses`` zeroes the
    same terms."""
    from attentionshift_torch.utils import check_finite_losses, guard_losses
    from attentionshift_tpu.utils import check_finite_losses as jcheck
    from attentionshift_tpu.utils import guard_losses as jguard

    losses = {"loss_a": 1.5, "loss_b": bad, "acc": 3.0}
    with pytest.raises(FloatingPointError) as ours:
        check_finite_losses({k: torch.tensor(v) for k, v in losses.items()}, step=7)
    with pytest.raises(FloatingPointError) as theirs:
        jcheck({k: jnp.asarray(v) for k, v in losses.items()}, step=7)
    assert str(ours.value) == str(theirs.value)
    check_finite_losses({"loss_a": 1.0}, step=1)
    got = guard_losses({k: torch.tensor(v) for k, v in losses.items()})
    want = jguard({k: jnp.asarray(v) for k, v in losses.items()})
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    assert float(got["loss_b"]) == 0.0


def test_dump_and_profiling_utils(tmp_path, capsys):
    """``finite_or_dump`` writes what the JAX twin writes (``name.npy`` under
    the dump directory) and raises the same error; ``profile_time`` prints
    its line, ``trace`` writes a Chrome trace into its directory, and
    ``Throughput`` counts images after its warm-up steps only."""
    from attentionshift_torch.utils import Throughput, finite_or_dump, profile_time, trace
    from attentionshift_tpu.utils import finite_or_dump as jdump

    x = np.asarray([1.0, np.nan, 2.0], np.float32)
    assert finite_or_dump(torch.ones(2), "fine", str(tmp_path)) is not None
    with pytest.raises(FloatingPointError) as ours:
        finite_or_dump(torch.from_numpy(x), "grad", str(tmp_path / "port"))
    with pytest.raises(FloatingPointError) as theirs:
        jdump(jnp.asarray(x), "grad", str(tmp_path / "jax"))
    assert str(ours.value).replace("port", "jax") == str(theirs.value)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "grad.npy"),
                                  np.load(tmp_path / "jax" / "grad.npy"))
    with profile_time("block"):
        torch.ones(4).sum()
    assert re.fullmatch(r"block: [0-9.]+ ms\n", capsys.readouterr().out)
    with trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    (path,) = (tmp_path / "trace").iterdir()
    assert "traceEvents" in json.loads(path.read_text())
    meter = Throughput(warmup=2)
    assert meter.rate() == 0.0
    for _ in range(4):
        meter.step(batch_size=2)
    assert meter.images == 4 and meter.rate() > 0.0


# --------------------------------------------------------------------- CLI


def test_cli_resume_equals_unbroken_run(tree, tmp_path, capsys):
    """``tools.train`` on the CPU, batch 1 over 3 images with accumulation
    over 2 and drop path on (the step's generator feeds it): a first call
    stopped after epoch 0 writes ``config.json``, ``train_log.jsonl``,
    ``epoch_1`` (inside an accumulation window) and the val metrics; a
    second call auto-resumes and runs epoch 1, and
    ``tools/analysis/analyze_logs.py time`` summarises the two epochs of
    its ``train_log.jsonl``; its ``epoch_2`` equals an unbroken 2-epoch
    run's bitwise (parameters, buffers, optimizer state, counters)."""
    from attentionshift_torch.tools import train as cli

    cfg = write_config(tmp_path / "tiny.py", tree, batch_size=1, drop_path_rate=0.1)
    broken, unbroken = tmp_path / "broken", tmp_path / "unbroken"
    common = ["--device", "cpu", "--validate-limit", "1"]
    first = cli.main([cfg, "--work-dir", str(broken), "--max-steps", "3", *common])
    out = capsys.readouterr().out
    assert sorted(p.name for p in broken.iterdir()) == ["config.json", "epoch_1", "train_log.jsonl"]
    assert json.loads((broken / "config.json").read_text())["model"]["depth"] == TINY["depth"]
    assert len((broken / "train_log.jsonl").read_text().splitlines()) == 3
    assert "epoch 0 val: {'mAP@0.25'" in out and first["val"][0].keys() == {
        "mAP@0.25", "mAP@0.5", "mAP@0.75"}
    assert out.rstrip().endswith("training done")
    ck1 = torch.load(broken / "epoch_1", weights_only=True)
    assert (ck1["epoch"], ck1["step"], ck1["opt_state"]["count"],
            ck1["opt_state"]["mini_step"]) == (1, 3, 1, 1)

    second = cli.main([cfg, "--work-dir", str(broken), *common])
    assert f"resumed from {broken / 'epoch_1'} (epoch 1)" in capsys.readouterr().out
    assert second["start_epoch"] == 1 and len(second["step_ms"]) == 3
    assert len((broken / "train_log.jsonl").read_text().splitlines()) == 6
    # the repo's log summary (no JAX, no twin) reads the port's log
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools/analysis/analyze_logs.py"),
                        "time", str(broken / "train_log.jsonl")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    logged = [json.loads(x) for x in (broken / "train_log.jsonl").read_text().splitlines()]
    assert r.stdout.splitlines() == [
        f"epoch {ep}: 3 logged iters, final loss_total {logged[3 * ep + 2]['loss_total']:.4f}"
        for ep in (0, 1)]
    cli.main([cfg, "--work-dir", str(unbroken), "--no-validate", "--device", "cpu"])
    a = torch.load(broken / "epoch_2", weights_only=True)
    b = torch.load(unbroken / "epoch_2", weights_only=True)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (6, 2)
    assert a["opt_state"]["count"] == 3
    for key in ("params",):
        assert all(torch.equal(a[key][k], b[key][k]) for k in b[key]), key
    for key in ("mu", "nu", "acc"):
        assert all(torch.equal(a["opt_state"][key][k], b["opt_state"][key][k])
                   for k in b["opt_state"][key]), key
    assert {k: v for k, v in a["opt_state"].items() if k not in ("mu", "nu", "acc")} == \
        {k: v for k, v in b["opt_state"].items() if k not in ("mu", "nu", "acc")}
    assert not torch.equal(a["params"]["mil_head.fc1.weight"], ck1["params"]["mil_head.fc1.weight"])
    drop_weights(tmp_path)


def test_loader_left_early_stops_its_workers():
    """A consumer that leaves an epoch after its first batch (the CLI's
    ``--max-steps``) leaves no worker thread behind, however far ahead the
    workers had decoded."""
    import threading
    import time

    from attentionshift_torch.data.loader import TrainLoader

    loader = TrainLoader(list(range(64)), lambda s, rng: dict(x=np.full(3, s), bucket="a"),
                         batch_size=2, num_threads=4, prefetch=1)
    before = threading.active_count()
    batches = loader.epoch(0)
    assert next(batches)["x"].shape == (2, 3)
    batches.close()
    deadline = time.monotonic() + 10.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


@pytest.mark.parametrize("opts, error", [
    (["model.num_classes=3"], ValueError),
    (["model_type=mask_rcnn"], TypeError),
    (["parallel.model=2"], ValueError),
    (["parallel.sequence_parallel=True", "parallel.model=2"], ValueError),
    (["parallel.data=2"], ValueError),
    (None, RuntimeError),
], ids=["num-class-check", "mask-rcnn", "tensor-parallel", "sequence-parallel", "data-degree",
        "cuda-default"])
def test_cli_raises(tree, tmp_path, opts, error):
    """The NumClassCheckHook analog, a model degree (tensor parallelism,
    with or without sequence parallelism) that does not divide the ranks, a
    data degree other than the ranks', the refinement stage's Mask R-CNN handed
    the AttnShift detector's model block (its ViT keys are not a Mask
    R-CNN's: ``tests/test_torch_refine_cli.py`` runs that path on its own
    config), and the card asked for by default on a machine without one:
    each raises before any step."""
    from attentionshift_torch.tools import train as cli

    cfg = write_config(tmp_path / "tiny.py", tree)
    argv = [cfg, "--work-dir", str(tmp_path / "w")]
    argv += ["--device", "cpu", "--cfg-options", *opts] if opts else []
    with pytest.raises(error):
        cli.main(argv)
    assert not (tmp_path / "w" / "train_log.jsonl").exists()


def _runs(monkeypatch, cli) -> list:
    """Keep each ``run`` that ``cli.main`` fits, with the parameters and
    buffers it started from."""
    runs, fit = [], cli.fit
    monkeypatch.setattr(cli, "fit", lambda run: (runs.append(
        (run, {k: v.clone() for k, v in run.model.state_dict().items()})), fit(run))[1])
    return runs


def test_cli_teacher_config_runs_resumes_and_is_not_checkpointed(tree, tmp_path, monkeypatch):
    """``teacher.enabled`` (``configs/attnshift_voc12aug_ts.py``'s block) on
    the CPU: two micro-steps through the teacher-student step with finite
    losses; the teacher starts as the student and ends as the EMA of the
    students after each update (not equal to either); ``epoch_1`` holds the
    student alone; a resumed build starts its teacher as the restored
    student, bitwise."""
    from attentionshift_torch.tools import train as cli

    cfg = write_config(tmp_path / "ts.py", tree, batch_size=1,
                       extra="teacher = dict(enabled=True, momentum=0.9)\n")
    runs = _runs(monkeypatch, cli)
    work = tmp_path / "w"
    stats = cli.main([cfg, "--work-dir", str(work), "--max-steps", "2", "--no-validate",
                      "--device", "cpu"])
    run, init = runs[0]
    assert len(stats["step_ms"]) == 2 and run.state.step == 2
    assert all(np.isfinite(v) for v in stats["metrics"].values())
    teacher, student = run.teacher.state_dict(), run.model.state_dict()
    name = "mil_head.fc1.weight"
    assert not torch.equal(teacher[name], student[name])
    assert not torch.equal(teacher[name], init[name])
    ckpt = torch.load(work / "epoch_1", weights_only=True)
    assert set(ckpt) == {"step", "epoch", "params", "opt_state"}  # no teacher
    assert set(ckpt["params"]) == set(student)
    assert all(torch.equal(ckpt["params"][k], v) for k, v in student.items())
    resumed = cli.build(cli.parse_args([cfg, "--work-dir", str(work), "--device", "cpu"]))
    assert resumed.resumed == str(work / "epoch_1")
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(resumed.teacher.state_dict()[k], v), k
    assert torch.equal(resumed.model.state_dict()[name], student[name])
    drop_weights(tmp_path)


def test_cli_coco_config_runs_the_reppoints_cascade(tmp_path, monkeypatch):
    """``configs/attnshift_coco.py`` (80 classes, max_gt 40, the RepPoints
    head) at TINY width on a synthetic COCO tree, on the CPU: two
    micro-steps with finite ``loss_rp_*`` losses, and the cascade head's
    parameters moved."""
    from attentionshift_torch.tools import train as cli

    data = coco_tree(tmp_path / "coco")
    tiny = {k: v for k, v in MODEL_KW.items() if k not in ("max_gt", "num_classes")}
    cfg = tmp_path / "coco_tiny.py"
    cfg.write_text(f"""
_base_ = [{str(REPO + "/configs/attnshift_coco.py")!r}]
model = dict(**{dict(tiny, use_remat=False)!r})
data = dict(train=dict(ann_file={data['ann_file']!r}, img_prefix={data['img_prefix']!r}),
            batch_size=1, num_threads=1, train_scales=[{TRAIN_SCALE!r}])
runtime = dict(log_interval=1)
""")
    runs = _runs(monkeypatch, cli)
    stats = cli.main([str(cfg), "--work-dir", str(tmp_path / "w"), "--max-steps", "2",
                      "--no-validate", "--device", "cpu"])
    run, init = runs[0]
    c = run.cfg.model
    assert (c.num_classes, c.max_gt, c.with_reppoints_head, c.num_semantic_points) == (80, 40, True, 3)
    assert run.model.num_reppoints_head == 1 and len(stats["step_ms"]) == 2
    rp = {k: v for k, v in stats["metrics"].items() if k.startswith("loss_rp_")}
    assert set(rp) == {"loss_rp_border", "loss_rp_chamfer_sem", "loss_rp_chamfer_contour",
                       "loss_rp_cls"} and all(np.isfinite(v) for v in rp.values())
    moved = [k for k, v in run.model.state_dict().items()
             if k.startswith("reppoints_head_0.") and not torch.equal(v, init[k])]
    assert moved
    drop_weights(tmp_path)


@pytest.fixture(scope="module")
def first_step(tree, tmp_path_factory):
    """The CLI's ``build`` over the tree (batch 2), its model loaded with a
    JAX model's random init; the first batch of its loader; the JAX train
    forward's losses and gradient on that batch with the JAX step's sampling
    key (``split(fold_in(PRNGKey(seed + 1), step))[0]``, `train/step.py:33`)
    and the draws it made."""
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.tools import train as cli

    d = tmp_path_factory.mktemp("first")
    run = cli.build(cli.parse_args([write_config(d / "tiny.py", tree), "--work-dir", str(d / "w"),
                                    "--device", "cpu"]))
    batches = run.loader.epoch(0)
    batch = next(batches)
    batches.close()
    kw = {k: v for k, v in MODEL_KW.items()}
    jm = jax_model(**kw)
    variables = random_variables(jm, tuple(batch[k][:1] for k in (
        "img", "gt_points", "gt_labels", "gt_valid", "img_wh")))
    load_flax(run.model, jax.tree.map(np.asarray, variables))
    key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(run.seed + 1), 0))[0]
    losses, grads, draws = jax_train_reference(jm, variables, batch, key, kw)
    return run, batch, variables, losses, grads, draws


def test_first_cli_step_matches_jax(first_step):
    """The first step through ``build(args)`` and ``train_step`` on the
    JAX init and the JAX draws, batch 2 from the CLI's own loader: every
    loss (2e-4 of max(1, |loss|); the MIL bag loss 2e-3) and every
    parameter's gradient (2e-3 of each tensor's largest entry), as
    ``test_torch_train_step_random.py`` holds the step."""
    from attentionshift_torch.tools import train as cli

    run, batch, _, jlosses, jgrads, draws = first_step
    assert batch["img"].shape == (2, *TRAIN_SCALE, 3)
    opt = run.state.optimizer
    seen, inner = [], opt.step
    opt.step = lambda grads: (seen.append(dict(zip(opt.names, [g.clone() for g in grads]))),
                              inner(grads))[1]
    try:
        metrics = cli.train_step(run, batch, epoch=0, draws=draws)
    finally:
        opt.step = inner
    assert set(metrics) == set(jlosses) | {"loss_total"}
    for name, ref in jlosses.items():
        tol = ABS_TOL["loss_mil"] if name == "loss_mil" else 2e-4 * max(1.0, abs(ref))
        close(float(metrics[name]), ref, tol, what=name)
    total = sum(v for k, v in jlosses.items() if k.startswith("loss"))
    close(float(metrics["loss_total"]), total, 2e-4 * max(1.0, abs(total)) + 2e-3, what="total")
    check_tree(seen[0], torch_tree(jgrads), 2e-3, "grad")
    assert run.state.step == 1 and opt.mini_step == 1 and opt.count == 0


def test_layer_decay_divergence_pinned(first_step):
    """ROADMAP section C. The JAX CLI (`tools/train.py:209`) hands
    ``build_optimizer`` the whole ``{"params", "batch_stats"}`` dict: every
    path then starts with "params", so every lr scale is 1.0, and the
    running statistics get Adam moments. The port's CLI follows the
    documented rule: its optimizer's lr scales equal the JAX ``lr_scale_tree``
    of ``variables["params"]`` (layer decay 0.75 over the blocks), and it
    holds no buffer."""
    from attentionshift_tpu.train.optim import build_optimizer as jbuild
    from attentionshift_tpu.train.optim import lr_scale_tree

    from test_torch_support import adam_state

    run, _, variables, *_ = first_step
    depth = TINY["depth"]
    as_cli = lr_scale_tree(variables, 0.75, depth)
    assert "batch_stats" in as_cli
    assert set(jax.tree_util.tree_leaves(as_cli)) == {1.0}
    mu = adam_state(jbuild(variables, depth=depth).init(variables)).mu
    assert "batch_stats" in mu
    rule = lr_scale_tree(variables["params"], 0.75, depth)
    want = {k: float(v.reshape(-1)[0]) for k, v in torch_tree(jax.tree.map(
        lambda p, s: np.full(np.shape(p), s, np.float32), variables["params"], rule)).items()}
    opt = run.state.optimizer
    assert dict(zip(opt.names, opt.scales)) == pytest.approx(want, rel=1e-6)
    assert len(set(opt.scales)) == depth + 2
    buffers = {n for n, _ in run.model.named_buffers()}
    assert buffers and not buffers & set(opt.names)


def test_run_train_commands(monkeypatch, capsys):
    """``python -m attentionshift_torch.run_train ARGS``: the train twin on
    the VOC config with ARGS, then the test twin with ``--aug-test`` on
    ``epoch_12`` (and the same ``--device``), each a checked subprocess
    printed with ``+``."""
    from attentionshift_torch import run_train

    calls = []
    monkeypatch.setattr(run_train.subprocess, "run",
                        lambda cmd, check: calls.append((cmd, check)))
    run_train.main(["--device", "cpu", "--max-steps", "1"])
    work = "work_dirs/attnshift_voc12aug"
    assert calls == [
        ([sys.executable, "-m", "attentionshift_torch.tools.train", "configs/attnshift_voc12aug.py",
          "--work-dir", work, "--device", "cpu", "--max-steps", "1"], True),
        ([sys.executable, "-m", "attentionshift_torch.tools.test", "configs/attnshift_voc12aug.py",
          f"{work}/epoch_12", "--aug-test", "--out", f"{work}/eval.json", "--device", "cpu"], True),
    ]
    printed = capsys.readouterr().out.splitlines()
    assert printed == ["+ " + " ".join(cmd) for cmd, _ in calls]
