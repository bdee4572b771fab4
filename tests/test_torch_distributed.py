"""Data-parallel training and evaluation of the port over two processes.

Two worker processes (this file run as a script) form a ``gloo`` process
group on the CPU through ``parallel.mesh.init_distributed``, as
``torchrun`` would set them up, and each takes one image of a global batch
of two. The parent holds what they compute against the JAX package's
train step on the whole batch of two, on the same TINY weights and draws:

- the global losses that rank 0 logs, every gradient after the
  all-reduce and every parameter after the update, on both ranks;
- a control: the same step with the loss normalisers left per rank (no
  all-reduce) misses the JAX losses and gradients;
- the same for the train variants' step (a RepPoints cascade of two heads
  with ``with_deform_sup`` and the MAE head), whose chamfer, border,
  objectness and MAE normalisers are global counts too; its control
  misses the JAX cascade losses;
- the train CLI's loader on each rank yields ``TrainLoader(process_index,
  process_count)``'s batches;
- ``tools.test --gather-dir`` over both ranks prints the single-process
  metric dict on rank 0 and nothing on rank 1.
- ``tools.train.main`` over both ranks for two epochs of a tree that
  mixes landscape and portrait images, whose shards fill different
  numbers of batches: both ranks run the same steps and end with the same
  parameters.

The images carry 3 and 2 annotated points, so that every per-rank count
differs from the global one.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_VALID = (3, 2)  # annotated instances of the two images
H, W = 64, 96
# the train variants of the second step: the RepPoints cascade and the MAE head
VARIANT = dict(with_reppoints_head=True, num_reppoints_head=2, with_deform_sup=True,
               reppoints_num_points=5, reppoints_contour_points=8, with_mae_head=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ----------------------------------------------------------------- workers


def worker(rank: int, world: int, out: str) -> None:
    """One rank: the train step with and without the normaliser
    all-reduce, the CLI loader, the evaluation gather; results to
    ``out/rank{rank}.pt``."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from attentionshift_torch.core import losses_geom
    from attentionshift_torch.data.loader import TrainLoader
    from attentionshift_torch.models import AttnShiftDetector, detector, heads, mae_head, reppoints
    from attentionshift_torch.parallel import mesh
    from attentionshift_torch.tools import test as test_cli
    from attentionshift_torch.tools import train as train_cli
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step

    r, w, dev = mesh.init_distributed(torch.device("cpu"))
    assert (r, w, dev.type) == (rank, world, "cpu") and dist.get_backend() == "gloo"
    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=True)
    batch = {k: v[rank:rank + 1] for k, v in inp["batch"].items()}

    def step(reduce_normalisers: bool, case: str = "") -> dict:
        kw = inp[case + "kw"]
        model = AttnShiftDetector(device="cpu", **kw)
        model.load_state_dict(inp[case + "state"], strict=True)
        opt = build_optimizer(model, accumulate_steps=1, depth=kw["depth"], **inp["opt"])
        seen, inner = [], opt.step
        opt.step = lambda grads: (seen.append([g.clone() for g in grads]), inner(grads))[1]
        fn = make_train_step(model, dist.group.WORLD)
        # the modules whose losses take the normalisers
        users = (detector, heads, losses_geom, reppoints, mae_head)
        if not reduce_normalisers:  # the control: each rank's own counts
            for mod in users:
                mod.global_count = lambda n: n.clamp_min(1.0)
        try:
            _, metrics = fn(TrainState.create(model, opt), batch, draws=[inp[case + "draws"][rank]])
        finally:
            for mod in users:
                mod.global_count = mesh.global_count
        return dict(metrics={k: float(v) for k, v in metrics.items()},
                    grads=dict(zip(opt.names, seen[0])),
                    params={n: p.detach().clone() for n, p in model.named_parameters()},
                    scales=dict(zip(opt.names, opt.scales)))

    mesh.COUNTS.clear()
    res = dict(step=step(True), counts=dict(mesh.COUNTS), control=step(False))
    mesh.COUNTS.clear()
    res.update(variant=step(True, "variant_"), variant_counts=dict(mesh.COUNTS),
               variant_control=step(False, "variant_"))

    # the train CLI's loader strides the dataset by rank
    run = train_cli.build(train_cli.parse_args(
        [inp["cfg"], "--work-dir", os.path.join(out, "work"), "--device", "cpu"]))
    ref = TrainLoader(run.dataset, run.loader.pipeline, batch_size=run.loader.batch_size,
                      seed=run.seed, num_threads=1, process_index=rank, process_count=world)
    got, want = list(run.loader.epoch(0)), list(ref.epoch(0))
    res["loader"] = len(got) == len(want) > 0 and all(
        np.array_equal(a[k], b[k]) for a, b in zip(got, want) for k in a)
    res["loader_points"] = [b["gt_points"] for b in got]

    # the evaluation CLI's gather over both ranks
    res["eval"] = test_cli.main([inp["cfg"], inp["ckpt"], "--gather-dir",
                                 os.path.join(out, "gather"), "--limit", "2", "--device", "cpu"])

    # the train CLI over both ranks on the mixed-orientation tree
    runs, fit, step, per_epoch = [], train_cli.fit, train_cli.train_step, [0, 0]
    train_cli.fit = lambda run: (runs.append((run, {n: p.detach().clone() for n, p in
                                                    run.model.named_parameters()})), fit(run))[1]

    def counted_step(run, batch, epoch, draws=None):
        per_epoch[epoch] += 1
        return step(run, batch, epoch, draws)

    train_cli.train_step = counted_step
    try:
        stats = train_cli.main([inp["mixed_cfg"], "--work-dir", os.path.join(out, "work_mixed"),
                                "--no-validate", "--device", "cpu"])
    finally:
        train_cli.fit, train_cli.train_step = fit, step
    run, init = runs[0]
    res["mixed"] = dict(steps=len(stats["step_ms"]), state_step=run.state.step, per_epoch=per_epoch,
                        steps_per_epoch=[run.loader.steps_per_epoch(e) for e in range(2)],
                        params={n: p.detach().clone() for n, p in run.model.named_parameters()},
                        moved=sum(not torch.equal(p, init[n])
                                  for n, p in run.model.named_parameters()))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    print(f"WORKER {rank} OK", flush=True)


# -------------------------------------------------------------------- test


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX step on the batch of two, the inputs written for the
    workers, both workers run; (JAX losses, gradients, updated parameters,
    each rank's results, the config and checkpoint paths)."""
    import jax

    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.train import save_params
    from attentionshift_tpu.train import TrainState as JState
    from attentionshift_tpu.train import build_optimizer as jbuild
    from test_torch_support import (TINY, TRAIN_OPT, TRAIN_SIZES, blob_inputs, disc_tree,
                                    jax_model, jax_train_reference, random_variables, torch_tree,
                                    voc_tree)

    tmp_path = tmp_path_factory.mktemp("dist")
    kw = dict(TINY, max_gt=4, pad_tokens_to=128, drop_path_rate=0.0, **TRAIN_SIZES,
              test_max_per_img=20)
    images = [blob_inputs(H, W, 4, n, seed=i) for i, n in enumerate(N_VALID)]
    names = ("img", "gt_points", "gt_labels", "gt_valid", "img_wh")
    batch = {n: np.concatenate([im[j] for im in images]) for j, n in enumerate(names)}
    jm = jax_model(**kw)
    variables = random_variables(jm, images[0])
    key = jax.random.PRNGKey(5)
    jlosses, jgrads, draws = jax_train_reference(jm, variables, batch, key, kw)
    jstate = JState.create(variables["params"], jbuild(variables["params"], accumulate_steps=1,
                                                       depth=kw["depth"], **TRAIN_OPT))
    want_params = torch_tree(jstate.apply_gradients(jgrads).params)
    want_grads = torch_tree(jgrads)
    # the train variants' step on the same batch
    var_kw = dict(kw, **VARIANT)
    vjm = jax_model(**var_kw)
    var_variables = random_variables(vjm, images[0])
    vlosses, vgrads, var_draws = jax_train_reference(vjm, var_variables, batch, key, var_kw)
    vstate = JState.create(var_variables["params"], jbuild(
        var_variables["params"], accumulate_steps=1, depth=kw["depth"], **TRAIN_OPT))
    variant = dict(jlosses=vlosses, want_grads=torch_tree(vgrads),
                   want_params=torch_tree(vstate.apply_gradients(vgrads).params))

    from attentionshift_tpu import data as jdata

    state = flax_to_torch(jax.tree.map(np.asarray, variables))
    ckpt = save_params(str(tmp_path / "epoch_1"), state)
    val = voc_tree(tmp_path / "VOC2012")
    train = disc_tree(tmp_path / "discs", sizes=((H, W),) * 4)
    cfg = tmp_path / "tiny.py"
    cfg.write_text(f"""
model = dict(**{dict(kw, use_remat=False)!r})
data = dict(train=dict(ann_file={train['ann_file']!r}, img_prefix={train['img_prefix']!r}),
            val=dict(split_file={val['split_file']!r}, voc_root={val['voc_root']!r}),
            batch_size=1, num_threads=1, max_gt=4, flip_ratio=0.5, train_scales=[({H}, {W})],
            test_scale=(96, 160))
optimizer = dict(base_lr=1e-3, weight_decay=0.05, layer_decay=0.75, accumulate_steps=2)
schedule = dict(total_epochs=1, decay_epochs=[8, 11], warmup_iters=2, warmup_ratio=1e-3)
runtime = dict(log_interval=1, checkpoint_interval=1, eval_interval=1, seed=0,
               loss_weight_start_epoch=-1)
""")
    # 3 landscape and 5 portrait images at batch 2: whichever way a shard of
    # 4 splits them, the two shards fill 1 and 2 batches
    mixed = disc_tree(tmp_path / "mixed", sizes=((H, W),) * 3 + ((W, H),) * 5)
    mixed_cfg = tmp_path / "mixed.py"
    mixed_cfg.write_text(cfg.read_text().replace(repr(train["ann_file"]), repr(mixed["ann_file"]))
                         .replace(repr(train["img_prefix"]), repr(mixed["img_prefix"]))
                         .replace("batch_size=1", "batch_size=2")
                         .replace("accumulate_steps=2", "accumulate_steps=1")
                         .replace("total_epochs=1", "total_epochs=2"))
    jds = jdata.VOCPointDataset(mixed["ann_file"], mixed["img_prefix"])
    jpipe = jdata.TrainPipeline(scales=((H, W),), max_gt=4)
    jax_counts = [[len(list(jdata.TrainLoader(jds, jpipe, 2, seed=0, num_threads=1,
                                              process_index=r, process_count=2).epoch(e)))
                   for r in range(2)] for e in range(2)]
    torch.save(dict(state=state, batch={k: torch.from_numpy(v) for k, v in batch.items()},
                    draws=draws, kw=dict(kw, use_remat=False), opt=TRAIN_OPT, cfg=str(cfg),
                    ckpt=ckpt, mixed_cfg=str(mixed_cfg),
                    variant_state=flax_to_torch(jax.tree.map(np.asarray, var_variables)),
                    variant_kw=dict(var_kw, use_remat=False), variant_draws=var_draws),
               tmp_path / "inputs.pt")

    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), "2", str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0 and f"WORKER {rank} OK" in log, log[-4000:]
    return dict(jlosses=jlosses, want_grads=want_grads, want_params=want_params,
                ranks=[torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)],
                cfg=str(cfg), ckpt=ckpt, jax_counts=jax_counts, variant=variant)


def _within(jlosses: dict, metrics: dict) -> dict:
    """Per loss: |port - JAX| over its limit (<= 1 passes): 2e-4 of
    max(1, |loss|), the MIL bag loss 2e-3, as ``test_torch_train_step_random.py``."""
    from test_torch_support import ABS_TOL

    out = {}
    for name, ref in jlosses.items():
        tol = ABS_TOL["loss_mil"] if name == "loss_mil" else 2e-4 * max(1.0, abs(ref))
        out[name] = abs(metrics[name] - ref) / tol
    return out


def _check_two_rank_step(want: dict, ranks: list, key: str, normalisers: int) -> None:
    """Rank 0's losses, the all-reduced gradients on both ranks (2e-3 of
    each tensor's largest entry), the parameters after the update on both
    ranks (within 2.2 lr of the JAX ones, equal across the ranks), and the
    all-reduces: one per normaliser, one of the gradients, one of the
    metrics."""
    from test_torch_support import TRAIN_OPT, check_tree

    jlosses, step0 = want["jlosses"], ranks[0][key]
    assert set(step0["metrics"]) == set(jlosses) | {"loss_total"}
    assert max(_within(jlosses, step0["metrics"]).values()) <= 1.0, _within(jlosses, step0["metrics"])
    for r in ranks:
        assert r[key]["metrics"] == step0["metrics"]  # every rank logs the global values
        check_tree(r[key]["grads"], want["want_grads"], 2e-3, "grad")
        for name, ref in want["want_params"].items():
            lr = TRAIN_OPT["base_lr"] * r[key]["scales"][name]
            assert float((r[key]["params"][name] - ref).abs().max()) <= 2.2 * lr, name
            assert torch.equal(r[key]["params"][name], step0["params"][name]), name
        counts = r["counts" if key == "step" else key + "_counts"]
        assert counts == {"normalisers": normalisers, "gradients": 1, "metrics": 1}


def test_two_rank_step_matches_jax_global_batch(ranks):
    """Two gloo ranks with one image each against the JAX train step on
    both images, as ``test_torch_train_step_random.py`` holds the step;
    the MIL, point, box head and mask normalisers reduced."""
    _check_two_rank_step(ranks, ranks["ranks"], "step", 4)


def test_two_rank_variant_step_matches_jax_global_batch(ranks):
    """The same for the train variants' step: the RepPoints cascade of two
    heads (``with_deform_sup``) and the MAE head; besides the four base
    normalisers, per cascade stage the border, two chamfer and the
    objectness counts, and the MAE head's masked-patch count."""
    _check_two_rank_step(ranks["variant"], ranks["ranks"], "variant", 4 + 2 * 4 + 1)


def test_control_without_normaliser_allreduce_misses_jax(ranks):
    """The same step with each rank's own loss normalisers: its losses and
    its gradients fail the limits the real step meets."""
    from test_torch_support import check_tree

    ctl = _within(ranks["jlosses"], ranks["ranks"][0]["control"]["metrics"])
    assert max(ctl[k] for k in ("loss_mil", "loss_point_cls", "loss_cls", "loss_mask")) > 1.0, ctl
    with pytest.raises(AssertionError):
        check_tree(ranks["ranks"][0]["control"]["grads"], ranks["want_grads"], 2e-3, "grad")


def test_variant_control_without_normaliser_allreduce_misses_jax(ranks):
    """The variants' step with each rank's own counts: the images' 3 and 2
    instances put the cascade's border and chamfer losses off the JAX
    global-batch values."""
    want = ranks["variant"]["jlosses"]
    ctl = _within(want, ranks["ranks"][0]["variant_control"]["metrics"])
    assert max(ctl[k] for k in ("loss_rp_border", "loss_rp_chamfer_sem", "loss_rp_border_0")) > 1.0, ctl


def test_cli_loader_strides_by_rank(ranks):
    """The train CLI's loader on each rank yields the batches of
    ``TrainLoader(process_index=rank, process_count=2)``, and the two ranks
    see disjoint images that cover the dataset."""
    assert all(r["loader"] for r in ranks["ranks"])
    seen = np.concatenate([p for r in ranks["ranks"] for p in r["loader_points"]])
    assert len(seen) == 4 and len(np.unique(seen[:, 0, 1])) == 4


def test_eval_gather_prints_single_process_metrics(ranks):
    """``tools.test --gather-dir`` over both ranks: rank 0 returns (and
    prints) the metric dict of a single-process run, rank 1 none."""
    from attentionshift_torch.tools import test as test_cli

    single = test_cli.main([ranks["cfg"], ranks["ckpt"], "--limit", "2", "--device", "cpu"])
    assert ranks["ranks"][0]["eval"] == single and ranks["ranks"][1]["eval"] is None



def test_cli_ranks_run_equal_steps_on_mixed_orientations(ranks):
    """``tools.train.main`` on both ranks for two epochs of 3 landscape and
    5 portrait images at batch 2: in each epoch the JAX loader's two shards
    fill different numbers of batches, yet both ranks run the same steps in
    each epoch, the fewer of the two, as ``steps_per_epoch`` says, and end
    with the same parameters, moved from the seeded init."""
    jax_counts = ranks["jax_counts"]
    assert all(a != b for a, b in jax_counts), jax_counts
    m0, m1 = (r["mixed"] for r in ranks["ranks"])
    assert m0["per_epoch"] == m1["per_epoch"] == m0["steps_per_epoch"] == m1["steps_per_epoch"] \
        == [min(c) for c in jax_counts]
    assert m0["steps"] == m1["steps"] == m0["state_step"] == m1["state_step"] == sum(
        m0["per_epoch"]) > 0
    for name, p in m0["params"].items():
        assert torch.equal(p, m1["params"][name]), name
    assert m0["moved"] == m1["moved"] > 0


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
