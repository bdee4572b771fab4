"""Tensor, sequence and pipeline parallelism of the port over four processes.

Four worker processes (this file run as a script) form a ``gloo`` process
group on the CPU and lay it out as ``parallel.mesh.make_mesh(2, 2)``: two
data replicas of a model group of two. The parent holds what they compute
against the JAX package on one device, on the same weights (converted
with ``convert.flax_to_torch``) and inputs (numpy, seeded). The JAX
package's own tests show that its sharded forms equal its single-device
forms (``tests/test_train.py``, ``tests/test_pipeline_parallel.py``), so
the port's sharded forms are held to the single-device JAX twin, except
``gpipe``, which is held to the JAX ``gpipe`` on its 8-device CPU mesh:

- the tensor-parallel ViT forward (heads and MLP sharded, 3 heads per
  rank), and the same with the sequence sharded, at a token count the
  group divides and at one it does not, against ``model.apply``;
- the capture attention on head shards, forward and backward, against
  the JAX ``attention_with_capture``'s plain path;
- ``gpipe`` (M = S and M > S), ``gpipe_aux`` and ``vit_forward_pp``;
- the dp x tp x sp train step of the detector (losses, gradients, the
  updated parameters) against the JAX step on the whole batch, with its
  draws replayed (``test_torch_support``);
- four controls, each of which misses the JAX values: the capture mean
  not reduced over the model group, the sequence-parallel gradients not
  reduced, the row-parallel partial sums sliced to the rank's tokens
  instead of reduce-scattered, the pipeline's two stages swapped;
- ``tools.train.main`` over two of the ranks with ``parallel.model=2
  parallel.data=1 parallel.sequence_parallel=True``.

Tolerances (f32 on the CPU; the sharded sums only reorder additions):
forwards and the attention 2e-4 relative + 2e-5 absolute (the JAX
package's own TP tests); the train step as ``test_torch_distributed.py``
holds it (losses 2e-4 of max(1, |loss|), the MIL loss 2e-3, gradients
2e-3 of each tensor's largest entry, parameters within 2.2 lr).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
N_VALID = (3, 2)  # annotated instances of the detector's two images
# the ViT of the forward cases: ViT-S's 6 heads (3 per rank) at width 96
VIT = dict(img_size=64, embed_dim=96, depth=4, num_heads=6, out_indices=(0, 1, 2, 3),
           point_tokens_num=8, num_classes=5, capture_layers=2)
# T = 1 + 24 + 8 = 33 tokens (odd: the last shard is padded), and with the
# gap to 48 (divisible by 2)
PADS = {"uneven": 0, "even": 16}
RTOL, ATOL = 2e-4, 2e-5
DIM, HEADS, TOK = 32, 2, 16  # the pipeline's blocks (tests/test_pipeline_parallel.py)
MICRO = {"m_eq_s": 2, "m_gt_s": 5}
VIT_KEYS = ("point_tokens", "outputs_class", "outputs_coord", "last_feat", "attns", "org_feats")


def _det_kw() -> dict:
    """The TINY detector of the train step (``test_torch_distributed.py``'s)."""
    from test_torch_support import TINY, TRAIN_SIZES

    return dict(TINY, max_gt=4, pad_tokens_to=128, drop_path_rate=0.0, **TRAIN_SIZES)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


# ----------------------------------------------------------------- workers


def worker(rank: int, world: int, out: str) -> None:
    """One rank of the 2 x 2 mesh: every case, results to
    ``out/rank{rank}.pt``; ranks 0 and 1 then run the train CLI as a model
    group of two."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.func import functional_call

    from attentionshift_torch.models import AttnShiftDetector, layers
    from attentionshift_torch.models.layers import Block
    from attentionshift_torch.models.vit import VisionTransformerDet, vit_forward_pp
    from attentionshift_torch.ops import attention
    from attentionshift_torch.parallel import gpipe, gpipe_aux, mesh as pmesh, pp as pp_mod
    from attentionshift_torch.parallel import shard_stage_params, stack_stage_params
    from attentionshift_torch.parallel.tp import TPContext, scatter_to_sp, shard_params_tp
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step
    from attentionshift_torch.train import step as step_mod

    r, w, _ = pmesh.init_distributed(torch.device("cpu"))
    assert (r, w) == (rank, world) and dist.get_backend() == "gloo"
    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=True)
    mesh = pmesh.make_mesh(2, 2)
    d, m = mesh.data_index, mesh.model_index
    assert rank == d * 2 + m
    tp = TPContext(mesh.model_group, 2, m)
    res = dict(mesh=(d, m))

    # the layout: the config's block and its refusals
    res["layouts"] = {}
    for name, cfg in (("model2", {"model": 2}), ("data2", {"model": 2, "data": 2}),
                      ("data1", {"model": 2, "data": 1}), ("model3", {"model": 3})):
        try:
            got = pmesh.mesh_from_config(cfg, world)
            res["layouts"][name] = (got.data, got.model, got.data_index, got.model_index)
        except ValueError as e:
            res["layouts"][name] = str(e)

    def vit(case: str, sp: bool):
        model = VisionTransformerDet(**VIT, pad_tokens_to=PADS[case], sequence_parallel=sp)
        model.load_state_dict(inp[f"vit_{case}"])
        return model

    def sharded_forward(case: str, sp: bool) -> dict:
        model = vit(case, sp)
        shard_params_tp(model, mesh)
        with torch.no_grad():
            o = model(inp["vit_img"][d:d + 1], with_features=True)
        return {k: o[k] for k in VIT_KEYS}

    res["tp"] = sharded_forward("uneven", False)
    with mock.patch.object(attention, "reduce_capture", lambda mean, tp: mean):
        res["tp_control"] = sharded_forward("uneven", False)["attns"]
    res["sp"] = {case: sharded_forward(case, True) for case in PADS}
    # the control: each row-parallel layer's partial sums sliced to the
    # rank's tokens instead of reduce-scattered
    with mock.patch.object(layers, "reduce_scatter_sp", scatter_to_sp):
        res["sp_control"] = sharded_forward("uneven", True)["last_feat"]

    # the capture attention on this rank's image and heads
    q, k, v = (inp["attn_" + n][d:d + 1, 3 * m:3 * m + 3].clone() for n in "qkv")
    q.requires_grad_(True)
    o, mean = attention.attention_with_capture_sharded(q, k, v, inp["attn_gap"], tp)
    (o * inp["attn_g"][d:d + 1, 3 * m:3 * m + 3]).sum().backward()
    plain = attention.attention_no_capture_sharded(q.detach(), k, v, inp["attn_gap"])
    res["attn"] = dict(out=o.detach(), mean=mean, dq=q.grad, plain=plain)

    # gpipe / gpipe_aux over the model group: this replica's microbatch column
    blocks = []
    for sd in inp["pp_stages"]:
        blk = Block(DIM, HEADS, mlp_ratio=2.0)
        blk.load_state_dict(sd)
        blocks.append(blk)
    mine = shard_stage_params(stack_stage_params([b.state_dict() for b in blocks]), tp)
    with torch.no_grad():
        res["gpipe"] = {case: gpipe(lambda p, mb: functional_call(blocks[0], p, (mb,))[0], mine,
                                    inp[f"pp_x_{case}"][:, d:d + 1], tp) for case in MICRO}
        res["gpipe_aux"] = gpipe_aux(
            lambda p, mb: (lambda y: (y[0], (y[1],)))(functional_call(blocks[0], p, (mb, True))),
            mine, inp["pp_x_m_eq_s"][:, d:d + 1], tp)
        pp = vit_forward_pp(vit("uneven", False), inp["vit_img"], tp, num_microbatches=2)
        # the control: the two stages swapped, each rank running the other's blocks
        with mock.patch.object(pp_mod, "shard_stage_params",
                               lambda st, tpc: {n: t[1 - tpc.rank] for n, t in st.items()}):
            res["vit_pp_control"] = vit_forward_pp(vit("uneven", False), inp["vit_img"], tp,
                                                   num_microbatches=2)["last_feat"]
    res["vit_pp"] = dict({k: pp[k] for k in VIT_KEYS}, feature=pp["feature"])

    # the dp x tp x sp train step of the detector
    def step(reduce_partial: bool) -> dict:
        kw = inp["det_kw"]
        model = AttnShiftDetector(device="cpu", **kw, sequence_parallel=True, use_remat=True)
        model.load_state_dict(inp["det_state"], strict=True)
        opt = build_optimizer(model, accumulate_steps=1, depth=kw["depth"], **inp["opt"])
        state = pmesh.place_state(TrainState.create(model, opt), mesh)
        seen, inner = [], opt.step
        opt.step = lambda grads: (seen.append([g.clone() for g in grads]), inner(grads))[1]
        fn = make_train_step(model, mesh)
        batch = {n: t[d:d + 1] for n, t in inp["det_batch"].items()}
        pmesh.COUNTS.clear()
        with mock.patch.object(step_mod, "reduce_partial_grads",
                               step_mod.reduce_partial_grads if reduce_partial
                               else (lambda names, grads, partial, tp: grads)):
            _, metrics = fn(state, batch, draws=[inp["det_draws"][d]])
        return dict(metrics={k: float(v) for k, v in metrics.items()},
                    grads=dict(zip(opt.names, seen[0])),
                    params={n: p.detach().clone() for n, p in model.named_parameters()},
                    scales=dict(zip(opt.names, opt.scales)), specs=dict(model.tp_specs),
                    counts=dict(pmesh.COUNTS))

    res["step"] = step(True)
    res["step_control"] = step(False)
    dist.destroy_process_group()

    if rank < 2:  # the train CLI as one model group of two ranks
        import contextlib
        import io

        from attentionshift_torch.tools import train as train_cli

        os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_PORT=inp["cli_port"])
        work = os.path.join(out, "work")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            stats = train_cli.main([inp["cfg"], "--work-dir", work, "--max-steps", "1",
                                    "--no-validate", "--device", "cpu", "--cfg-options",
                                    "parallel.model=2", "parallel.data=1",
                                    "parallel.sequence_parallel=True"])
        ckpt = os.path.join(work, "epoch_1")
        res["cli"] = dict(log=buf.getvalue(), steps=len(stats["step_ms"]),
                          metrics=stats["metrics"])
        if rank == 0:
            saved = torch.load(ckpt, weights_only=True)
            res["cli"]["shapes"] = {n: tuple(t.shape) for n, t in saved["params"].items()}
            res["cli"]["moment_shapes"] = {n: tuple(t.shape)
                                           for n, t in saved["opt_state"]["mu"].items()}
            os.remove(ckpt)  # 0.4 GB: the check needs only its shapes
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    print(f"WORKER {rank} OK", flush=True)


# -------------------------------------------------------------------- test


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs written for the workers, the four workers started, the
    JAX references computed while they run; (JAX results, each rank's
    results)."""
    import jax
    import jax.numpy as jnp

    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet
    from attentionshift_tpu.models.layers import Block as JBlock
    from attentionshift_tpu.models.vit import VisionTransformerDet as JViT
    from attentionshift_tpu.ops.attention import attention_with_capture as jattention
    from attentionshift_tpu.parallel.mesh import make_mesh as jmesh
    from attentionshift_tpu.parallel.pp import (gpipe as jgpipe, gpipe_aux as jgpipe_aux,
                                                shard_stage_params as jshard,
                                                stack_stage_params as jstack)
    from attentionshift_tpu.train import TrainState as JState
    from attentionshift_tpu.train import build_optimizer as jbuild
    from test_torch_support import (TRAIN_OPT, blob_inputs, disc_tree, drop_weights, jax_model,
                                    n_anchors, random_variables, replay_train_draws, torch_tree)

    tmp_path = tmp_path_factory.mktemp("parallel")
    rs = np.random.RandomState(0)
    want, inp, jvit = {}, {}, {}

    # ---- the workers' inputs: weights, data and the detector step's draws
    img = rs.randn(2, H, W, 3).astype(np.float32)
    inp["vit_img"] = torch.from_numpy(img)
    for case, pad in PADS.items():
        jvit[case] = JViT(**VIT, pad_tokens_to=pad, use_remat=False)
        variables = _np(jax.jit(jvit[case].init)(jax.random.PRNGKey(0), jnp.asarray(img)))
        sd = flax_to_torch({"params": {"backbone": variables["params"]},
                            "batch_stats": {"backbone": variables["batch_stats"]}})
        inp[f"vit_{case}"], jvit[case] = _strip(sd, "backbone."), (jvit[case], variables)
    q, k, v, g = (rs.randn(2, 6, 40, 16).astype(np.float32) for _ in range(4))
    gap = (30, 36)
    inp.update(attn_q=torch.from_numpy(q), attn_k=torch.from_numpy(k), attn_v=torch.from_numpy(v),
               attn_g=torch.from_numpy(g), attn_gap=gap)
    block = JBlock(num_heads=HEADS, mlp_ratio=2.0)
    x0 = jnp.asarray(rs.randn(2, TOK, DIM).astype(np.float32))
    per_stage = [block.init(jax.random.PRNGKey(i), x0)["params"] for i in range(2)]
    inp["pp_stages"] = [_strip(flax_to_torch({"params": {"backbone": {"blocks_0": p}}}),
                               "backbone.blocks.0.") for p in _np(per_stage)]
    for case, mb in MICRO.items():
        inp[f"pp_x_{case}"] = torch.from_numpy(rs.randn(mb, 2, TOK, DIM).astype(np.float32))

    kw = _det_kw()
    images = [blob_inputs(H, W, 4, n, seed=i) for i, n in enumerate(N_VALID)]
    names = ("img", "gt_points", "gt_labels", "gt_valid", "img_wh")
    batch = {n: np.concatenate([im[j] for im in images]) for j, n in enumerate(names)}
    jm = jax_model(**kw)
    variables = random_variables(jm, images[0])
    key = jax.random.PRNGKey(5)
    jargs = tuple(jnp.asarray(batch[n]) for n in names)
    # the JAX step's draws replayed per image (test_torch_support.jax_train_reference)
    dbg = jax.jit(lambda v_: jm.apply(v_, *jargs, method=JDet.seed_debug,
                                      rngs={"sampling": key}))(variables)
    draws = replay_train_draws(jm, variables, key, np.asarray(dbg["best_cams"]),
                               batch["gt_points"], kw.get("seed_map_stride", 4), (H, W),
                               n_anchors(H, W), batch["gt_points"].shape[1] + kw["num_proposals"],
                               kw["rcnn_samples"])
    inp.update(det_kw=kw, det_state=flax_to_torch(_np(variables)), det_draws=draws, opt=TRAIN_OPT,
               det_batch={k_: torch.from_numpy(v_) for k_, v_ in batch.items()})
    train = disc_tree(tmp_path / "discs", sizes=((H, W),) * 4)
    cfg = tmp_path / "tiny.py"
    cfg.write_text(f"""
model = dict(**{dict(kw, use_remat=False)!r})
data = dict(train=dict(ann_file={train['ann_file']!r}, img_prefix={train['img_prefix']!r}),
            batch_size=1, num_threads=1, max_gt=4, flip_ratio=0.5, train_scales=[({H}, {W})],
            test_scale=(96, 160))
optimizer = dict(base_lr=1e-3, weight_decay=0.05, layer_decay=0.75, accumulate_steps=1)
schedule = dict(total_epochs=1, decay_epochs=[8, 11], warmup_iters=2, warmup_ratio=1e-3)
runtime = dict(log_interval=1, checkpoint_interval=1, eval_interval=1, seed=0,
               loss_weight_start_epoch=-1)
""")
    inp.update(cfg=str(cfg), cli_port=str(_free_port()))
    torch.save(inp, tmp_path / "inputs.pt")

    port = str(_free_port())
    procs = []
    for rank in range(4):
        env = {k_: v_ for k_, v_ in os.environ.items() if k_ not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(RANK=str(rank), WORLD_SIZE="4", MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), "4", str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        # ---- the JAX references, while the workers run
        for case, (jm_, v_) in jvit.items():
            o = _np(jax.jit(jm_.apply)(v_, jnp.asarray(img)))
            want[f"vit_{case}"] = {k_: torch.from_numpy(np.asarray(o[k_])) for k_ in VIT_KEYS}
            want[f"vit_{case}"]["feature"] = [torch.from_numpy(np.asarray(f)) for f in o["feature"]]
        jo, jmean = jattention(*map(jnp.asarray, (q, k, v)), False, False, gap)
        jdq = jax.grad(lambda q_: (jattention(q_, jnp.asarray(k), jnp.asarray(v), False, False,
                                              gap)[0] * g).sum())(jnp.asarray(q))
        want["attn"] = dict(out=np.asarray(jo), mean=np.asarray(jmean), dq=np.asarray(jdq))
        # gpipe and gpipe_aux on the JAX 2 x 2 CPU mesh (data x pipeline)
        mesh = jmesh(jax.devices("cpu")[:4], model=2)
        stacked = jshard(jstack(per_stage), mesh)
        want["gpipe"] = {}
        for case in MICRO:
            with mesh:
                got = jax.jit(lambda p, xx: jgpipe(
                    lambda pp, t: block.apply({"params": pp}, t)[0], p, xx, mesh=mesh,
                    axis="model", data_axis="data"))(stacked, jnp.asarray(inp[f"pp_x_{case}"]))
            want["gpipe"][case] = torch.from_numpy(np.asarray(got))
        cap = JBlock(num_heads=HEADS, mlp_ratio=2.0, capture=True)
        with mesh:  # the aux buffers are not sharded over ``data``: the batch stays whole
            out, (aux,) = jax.jit(lambda p, xx: jgpipe_aux(
                lambda pp, t: (lambda y: (y[0], (y[1],)))(cap.apply({"params": pp}, t)), p, xx,
                (jax.ShapeDtypeStruct((2, TOK, TOK), jnp.float32),), mesh=mesh, axis="model"))(
                stacked, jnp.asarray(inp["pp_x_m_eq_s"].numpy()))
        want["gpipe_aux"] = (torch.from_numpy(np.asarray(out)), torch.from_numpy(np.asarray(aux)))
        # the JAX train step's losses and gradient on the batch of two
        bs = variables["batch_stats"]

        def loss_fn(params):
            losses, _ = jm.apply({"params": params, "batch_stats": bs}, *jargs,
                                 rngs={"sampling": key})
            return sum(l_ for n_, l_ in losses.items() if n_.startswith("loss")), losses

        (_, jlosses), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        jstate = JState.create(variables["params"], jbuild(
            variables["params"], accumulate_steps=1, depth=kw["depth"], **TRAIN_OPT))
        want["step"] = dict(jlosses={k_: float(v_) for k_, v_ in jlosses.items()},
                            grads=torch_tree(jgrads),
                            params=torch_tree(jstate.apply_gradients(jgrads).params))
        for rank, p in enumerate(procs):
            log, _ = p.communicate(timeout=600)
            assert p.returncode == 0 and f"WORKER {rank} OK" in log, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    yield dict(want=want, ranks=[torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
                                 for r in range(4)])
    drop_weights(tmp_path)


def _close(got, ref, what: str) -> None:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=what)


def _per_image(ref: dict, d: int) -> dict:
    """The JAX output of image d (attns carry the batch second)."""
    return {k: (v[:, d:d + 1] if k == "attns" else v[d:d + 1]) for k, v in ref.items()
            if k in VIT_KEYS}


def test_mesh_from_config_layouts(ranks):
    """rank = d * model + m; ``mesh_from_config`` fills the world with
    ``data x model`` ranks (``data`` defaults to the rest), refuses a
    ``data`` that leaves ranks without a slot and a model degree that does
    not divide the ranks."""
    for rank, r in enumerate(ranks["ranks"]):
        lay = r["layouts"]
        assert r["mesh"] == (rank // 2, rank % 2)
        assert lay["model2"] == lay["data2"] == (2, 2, rank // 2, rank % 2)
        assert "data=1 x model=2 != 4 ranks" in lay["data1"]
        assert "does not divide" in lay["model3"]


@pytest.mark.parametrize("asked, want", [(None, "nccl"), ("gloo", "gloo")])
def test_init_distributed_takes_the_backend_asked_for(monkeypatch, asked, want):
    """Sixteen ranks on a host of eight cards with no ``LOCAL_WORLD_SIZE``
    (what ``slurm_train.sh`` exports) keep ``nccl``: the backend is never
    guessed from the counts. Ranks that share a card ask for ``gloo``
    through ``ATTNSHIFT_DIST_BACKEND``; the rank takes card LOCAL_RANK
    modulo the count."""
    import torch.distributed as dist

    from attentionshift_torch.parallel import mesh as pmesh

    seen = {}
    for name in ("LOCAL_WORLD_SIZE", "ATTNSHIFT_DIST_BACKEND"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("RANK", "11")
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", "11")
    monkeypatch.setenv("MASTER_PORT", "29500")
    if asked:
        monkeypatch.setenv("ATTNSHIFT_DIST_BACKEND", asked)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend, **kw))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: seen.update(device=dev))
    rank, world, dev = pmesh.init_distributed(torch.device("cuda"))
    assert (rank, world, seen["backend"], seen["world_size"]) == (11, 16, want, 16)
    assert dev == seen["device"] == torch.device("cuda", 3)


def test_tensor_parallel_forward_matches_jax(ranks):
    """dp2 x tp2: each replica's image through the head- and MLP-sharded
    ViT (3 of 6 heads per rank) against the JAX forward of the batch:
    point tokens, classes, coordinates, last tokens, taps and the capture
    maps rebuilt over the model group."""
    for r in ranks["ranks"]:
        d, _ = r["mesh"]
        for k, ref in _per_image(ranks["want"]["vit_uneven"], d).items():
            _close(r["tp"][k], ref, k)


def test_control_sequence_not_reduce_scattered_misses_jax(ranks):
    """The control of the sequence-parallel forward: each row-parallel
    layer's partial sums sliced to the rank's tokens, not reduce-scattered
    over the model group, miss the JAX last tokens."""
    r = ranks["ranks"][0]
    with pytest.raises(AssertionError):
        _close(r["sp_control"], _per_image(ranks["want"]["vit_uneven"], 0)["last_feat"], "ctl")


def test_control_pipeline_stages_swapped_misses_jax(ranks):
    """The control of ``vit_forward_pp``: the two stages swapped (each rank
    runs the other's blocks) miss the JAX last tokens."""
    with pytest.raises(AssertionError):
        _close(ranks["ranks"][0]["vit_pp_control"], ranks["want"]["vit_uneven"]["last_feat"],
               "ctl")


def test_control_capture_mean_not_reduced_misses_jax(ranks):
    """The control: each rank's capture mean over its own 3 heads, not
    reduced over the model group, misses the JAX maps."""
    r = ranks["ranks"][0]
    with pytest.raises(AssertionError):
        _close(r["tp_control"], _per_image(ranks["want"]["vit_uneven"], 0)["attns"], "attns")


@pytest.mark.parametrize("case", sorted(PADS))
def test_sequence_parallel_forward_matches_jax(ranks, case):
    """Sequence parallelism over the model group (each rank 17 or 24 of
    the 33 / 48 tokens between the blocks, the last shard padded at 33)
    on top of tensor parallelism, against the JAX forward."""
    for r in ranks["ranks"]:
        d, _ = r["mesh"]
        for k, ref in _per_image(ranks["want"][f"vit_{case}"], d).items():
            _close(r["sp"][case][k], ref, k)


def test_sharded_capture_attention_matches_jax(ranks):
    """``attention_with_capture_sharded`` on a rank's 3 of 6 heads (gap
    [30, 36)): its heads' output and its q's gradient against the JAX
    plain path's, and the head mean over all 6 heads rebuilt with one
    all-reduce; ``attention_no_capture_sharded`` gives the same output."""
    want = ranks["want"]["attn"]
    for r in ranks["ranks"]:
        d, m = r["mesh"]
        heads = slice(3 * m, 3 * m + 3)
        _close(r["attn"]["out"], want["out"][d:d + 1, heads], "out")
        _close(r["attn"]["plain"], want["out"][d:d + 1, heads], "plain out")
        _close(r["attn"]["mean"], want["mean"][d:d + 1], "mean")
        _close(r["attn"]["dq"], want["dq"][d:d + 1, heads], "dq")


@pytest.mark.parametrize("case", sorted(MICRO))
def test_gpipe_matches_jax_gpipe(ranks, case):
    """Two stages over the model group, the microbatch batch split over
    the data replicas, against the JAX ``gpipe`` on its 2 x 2 CPU mesh:
    M = S = 2 and M = 5 > S; every rank ends with the outputs."""
    want = ranks["want"]["gpipe"][case]
    for r in ranks["ranks"]:
        d, _ = r["mesh"]
        _close(r["gpipe"][case], want[:, d:d + 1], case)


def test_gpipe_aux_keeps_each_stage_aux(ranks):
    """``gpipe_aux``: the outputs on every rank and, on each rank, its own
    stage's captured attention for every microbatch, against the JAX
    ``gpipe_aux``'s stage-major aux."""
    out, aux = ranks["want"]["gpipe_aux"]
    for r in ranks["ranks"]:
        d, m = r["mesh"]
        got_out, (got_aux,) = r["gpipe_aux"]
        _close(got_out, out[:, d:d + 1], "out")
        _close(got_aux, aux[m, :, d:d + 1], f"stage {m} aux")


def test_vit_forward_pp_matches_jax_forward(ranks):
    """``vit_forward_pp`` (2 stages x 2 microbatches, every block in
    capture mode) against the JAX plain forward: the output contract,
    the trailing capture maps and the pyramid, on every rank."""
    want = ranks["want"]["vit_uneven"]
    for r in ranks["ranks"]:
        for k in VIT_KEYS:
            _close(r["vit_pp"][k], want[k], k)
        for got, ref in zip(r["vit_pp"]["feature"], want["feature"]):
            _close(got, ref, "feature")


def _step_want(want: dict, specs: dict, m: int) -> tuple:
    """The JAX gradients and updated parameters cut to model rank m's
    shards."""
    from attentionshift_torch.parallel.tp import shard_tensor

    def cut(tree):
        return {n: t if specs.get(n) is None else shard_tensor(n, t, specs[n], m, 2)
                for n, t in tree.items()}

    return cut(want["grads"]), cut(want["params"])


def test_dp_tp_sp_train_step_matches_jax(ranks):
    """The detector's train step over dp2 x tp2 with sequence parallelism
    (each replica one image, the blocks' q, k, v, proj, fc1, fc2 and the
    decoder heads' sharded, the optimizer moments with them) against the
    JAX step on both images: the global losses on every rank, each rank's
    gradient shards and updated shards; the all-reduces: 4 normalisers,
    the gradients and the metrics over the data group, one of the
    sequence-partial gradients over the model group."""
    from test_torch_distributed import _within
    from test_torch_support import TRAIN_OPT, check_tree

    want = ranks["want"]["step"]
    for r in ranks["ranks"]:
        s = r["step"]
        _, m = r["mesh"]
        assert max(_within(want["jlosses"], s["metrics"]).values()) <= 1.0
        assert s["metrics"] == ranks["ranks"][0]["step"]["metrics"]
        assert sum(a is not None for a in s["specs"].values()) >= 4 * 6
        grads, params = _step_want(want, s["specs"], m)
        check_tree(s["grads"], grads, 2e-3, "grad")
        for name, ref in params.items():
            lr = TRAIN_OPT["base_lr"] * s["scales"][name]
            assert float((s["params"][name] - ref).abs().max()) <= 2.2 * lr, name
        assert s["counts"] == {"normalisers": 4, "gradients": 1, "metrics": 1,
                               "sequence_gradients": 1}


def test_control_sequence_gradients_not_reduced_misses_jax(ranks):
    """The control: the LayerNorm (and row-bias) gradients each rank took
    over its own tokens, not summed over the model group, miss the JAX
    gradients; the losses do not change."""
    from test_torch_support import check_tree

    r = ranks["ranks"][0]
    s = r["step_control"]
    grads, _ = _step_want(ranks["want"]["step"], s["specs"], r["mesh"][1])
    ln = [n for n in grads if n.startswith("backbone.blocks.") and ".norm1." in n]
    assert ln
    with pytest.raises(AssertionError):
        check_tree({n: s["grads"][n] for n in ln}, {n: grads[n] for n in ln}, 2e-3, "grad")
    assert s["metrics"] == r["step"]["metrics"]


def test_cli_trains_tensor_and_sequence_parallel(ranks):
    """``tools.train.main`` over two ranks with ``parallel.model=2
    parallel.data=1 parallel.sequence_parallel=True`` (the twin of
    ``tests/test_cli.py``'s TP case): it prints the mesh, finishes its
    step with the same finite losses on both ranks, and its checkpoint
    holds the full parameters and moments, gathered from the shards."""
    from attentionshift_torch.models import AttnShiftDetector

    r0, r1 = (ranks["ranks"][i]["cli"] for i in range(2))
    for c in (r0, r1):
        assert "parallel: mesh {'data': 1, 'model': 2}, sp=True" in c["log"], c["log"][-2000:]
        assert c["steps"] == 1 and all(np.isfinite(v) for v in c["metrics"].values())
    assert r0["metrics"] == r1["metrics"]
    full = AttnShiftDetector(device="cpu", **_det_kw()).state_dict()
    assert r0["shapes"] == {n: tuple(t.shape) for n, t in full.items()}
    assert r0["moment_shapes"]["backbone.blocks.0.attn.qkv.weight"] == (384, 128)


def test_tp_spec_tree_falls_back_to_replication():
    """The port's rules against the JAX ``_spec_for`` on the same layers:
    a divisible qkv shards (its output axis), an indivisible one stays
    replicated, the patch embedding's ``proj`` stays replicated; an
    attention whose heads the group does not divide stays replicated as a
    whole, its MLP still shards."""
    from jax.sharding import PartitionSpec as P

    from attentionshift_torch.models.layers import Block
    from attentionshift_torch.models.vit import VisionTransformerDet
    from attentionshift_torch.parallel.tp import _spec_for, tp_spec_tree
    from attentionshift_tpu.parallel.tp import _spec_for as jspec

    cases = [(("blocks_0", "attn", "qkv", "kernel"), (96, 288), ("blocks", "0", "attn", "qkv",
                                                                  "weight"), (288, 96)),
             (("blocks_0", "attn", "qkv", "kernel"), (96, 287), ("blocks", "0", "attn", "qkv",
                                                                  "weight"), (287, 96)),
             (("patch_embed", "proj", "kernel"), (16, 16, 3, 96), ("patch_embed", "proj",
                                                                   "weight"), (96, 768))]
    for jpath, jshape, path, shape in cases:
        assert (jspec(jpath, jshape, 2) == P()) == (_spec_for(path, shape, 2) is None)
    specs = tp_spec_tree(VisionTransformerDet(img_size=32, embed_dim=96, depth=1, num_heads=6), 2)
    assert specs["blocks.0.attn.qkv.weight"] == 0 and specs["blocks.0.attn.proj.weight"] == 1
    assert specs["blocks.0.mlp.fc2.weight"] == 1 and specs["patch_embed.proj.weight"] is None
    odd = tp_spec_tree(Block(96, 3), 2)
    assert odd["attn.qkv.weight"] is None and odd["attn.proj.weight"] is None
    assert odd["mlp.fc1.weight"] == 0 and odd["mlp.fc1.bias"] == 0


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
