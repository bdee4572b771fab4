"""Free-running training of both packages from the same weights, on the CPU.

The train-step parity tests (``test_torch_train_step_*.py``, through
``test_torch_support.run_both``) load the JAX weights into the port
before every step, so a difference that builds up over steps is never
seen. Here both packages step side by side without resets: the JAX
detector under ``jax.value_and_grad`` and optax, the port's detector
under its own ``make_train_step``, from the same converted weights (the
JAX model's own ``model.init``, key 0), on a two-lobed corpus drawn by
the learning check's recipe at 64 x 96, with the learning check's
optimizer (Adam, ``base_lr`` 1e-4, a 20-step linear warmup, every lr
scale 1.0), f32, at the narrow TINY model (4 blocks: the FPN taps four),
for ``STEPS`` steps. Each step the port takes the draws of the JAX run it
is compared with (``replay_train_draws``).

What counts as agreement is measured, not assumed. The control is the
JAX package against itself with every initial weight moved by one f32
ulp: its distance from the unmoved JAX run after ``STEPS`` steps, as a
share of how far the JAX run moved, ``delta_ctl``, is the spread that
rounding alone gives this recipe. The port's distance ``delta_port``
must stay within ``MULT`` times it, and a systematic difference of the
recipe, the second control (the port with ``warmup_iters`` 21: each
warmup step's lr 1/21 off), must fail the same limit. The first run
held the port to 1000x (the port rounds every operation differently, the
control perturbs the weights once) and measured, with the port on one
CPU thread: delta_ctl 3.351e-03 (the one-ulp move grows through the
pseudo-label engine's discrete choices), delta_port 3.290e-03 (0.98x),
the warmup control 0.2699 (80.5x), which 1000x could not see. ``MULT``
is 10 since: stricter, and the warmup control fails it. The port's steps
run on ``PORT_THREADS`` threads, which sum its CPU products in another
order than one thread: delta_port moves with it (3.156e-03 on two). Each step's total loss is also held to the
single-step tolerance of the same-weights comparison (``2e-4 * max(1,
|loss|)``). The RPN's regression weights are reported by name.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import (  # noqa: E402
    TINY, TRAIN_SIZES, jax_model, n_anchors, replay_train_draws, torch_model, torch_tree)

STEPS = 20
MULT = 10.0  # see the module docstring for the first run's 1000
H, W, G = 64, 96, 4
KW = dict(TINY, max_gt=G, pad_tokens_to=128, drop_path_rate=0.0, **TRAIN_SIZES)
OPT = dict(base_lr=1e-4, steps_per_epoch=100, warmup_iters=20, layer_decay=1.0, depth=4,
           accumulate_steps=1)
RPN_REG = ("rpn_head.rpn_reg.weight", "rpn_head.rpn_reg.bias")
PORT_THREADS = 2


def lobes_sample(rs, i):
    """One image of the learning check's two-lobed corpus (``make_sample``,
    ``corpus="lobes"``) at H x W: two instances, each a disc in one colour
    channel and a second, overlapping lobe in the next, one point each."""
    img = (rs.randn(H, W, 3) * 0.1).astype(np.float32)
    yy, xx = np.mgrid[:H, :W]
    pts = np.zeros((G, 2), np.float32)
    for j in range(2):
        cx, cy = rs.randint(W // 5, 4 * W // 5), rs.randint(H // 5, 4 * H // 5)
        r = rs.randint(H // 8, H // 5)
        color = np.zeros(3)
        color[(i + j) % 3] = 2.5
        img[((xx - cx) ** 2 + (yy - cy) ** 2) < r * r] += color
        dx = int(r * 0.8)
        img[((xx - cx - dx) ** 2 + (yy - cy) ** 2) < (r * 0.7) ** 2] += np.roll(color, 1) * 0.8
        pts[j] = (cx, cy)
    lbl = np.zeros((G,), np.int32)
    lbl[:2] = [i % 3, (i + 1) % 3]
    valid = np.asarray([True, True] + [False] * (G - 2))
    return (img[None], pts[None], lbl[None], valid[None],
            np.asarray([[float(W), float(H)]], np.float32))


def _moved_one_ulp(params):
    return jax.tree.map(lambda x: np.nextafter(np.asarray(x), np.float32(np.inf)), params)


class Recipe:
    """Both packages' train steps on the learning check's recipe at the
    model ``kw``: the corpus, the JAX model's ``model.init`` (key 0), the
    jitted JAX value-and-grad, ``seed_debug`` and optax update, and the
    draws of a JAX state replayed for the port."""

    def __init__(self, kw: dict):
        from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

        rs = np.random.RandomState(0)
        self.kw = kw
        self.corpus = [lobes_sample(rs, i) for i in range(4)]
        self.jmodel = jax_model(**kw)
        key0 = jax.random.PRNGKey(0)
        self.variables = jax.tree.map(np.asarray, jax.jit(lambda k: self.jmodel.init(
            {"params": k, "sampling": k, "dropout": k}, *map(jnp.asarray, self.corpus[0])))(key0))
        bs = self.bs = jax.tree.map(jnp.asarray, self.variables["batch_stats"])

        def loss_fn(params, args, key):
            losses, aux = self.jmodel.apply({"params": params, "batch_stats": bs}, *args,
                                            rngs={"sampling": key})
            return sum(v for k, v in losses.items() if k.startswith("loss")), (losses, aux)

        self.jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        self.jdebug = jax.jit(lambda p, args, k: self.jmodel.apply(
            {"params": p, "batch_stats": bs}, *args, method=JDet.seed_debug,
            rngs={"sampling": k}))
        self.japply = jax.jit(lambda st, g: st.apply_gradients(g))

    def step_inputs(self, i):
        """(JAX args, key, port batch) of step ``i``."""
        sample = self.corpus[i % len(self.corpus)]
        img, pts, lbl, val, wh = map(torch.from_numpy, sample)
        return (tuple(map(jnp.asarray, sample)), jax.random.PRNGKey(10 + i),
                dict(img=img, gt_points=pts, gt_labels=lbl, gt_valid=val, img_wh=wh))

    def draws(self, params, args, key):
        best = np.asarray(self.jdebug(params, args, key)["best_cams"])
        return replay_train_draws(self.jmodel, {"params": params, "batch_stats": self.bs}, key,
                                  best, np.asarray(args[1]), 4, (H, W), n_anchors(H, W),
                                  G + self.kw["num_proposals"], self.kw["rcnn_samples"])

    def jax_state(self, params):
        from attentionshift_tpu.train import TrainState as JState
        from attentionshift_tpu.train import build_optimizer as jbuild

        params = jax.tree.map(jnp.asarray, params)
        return JState.create(params, jbuild(params, **OPT))

    def port(self, **opt_over):
        """(port model, its train state, its step function)."""
        from attentionshift_torch.train import TrainState, build_optimizer, make_train_step

        model = torch_model(self.variables, **self.kw)
        state = TrainState.create(model, build_optimizer(model, **dict(OPT, **opt_over)))
        return model, state, make_train_step(model)


@pytest.fixture(scope="module")
def runs():
    rec = Recipe(KW)

    def jax_run(params, with_draws):
        st = rec.jax_state(params)
        losses, draws = [], []
        for i in range(STEPS):
            args, key, _ = rec.step_inputs(i)
            if with_draws:  # the port's draws; the JAX model draws from the key itself
                draws.append(rec.draws(st.params, args, key))
            (total, _), grads = rec.jgrad(st.params, args, key)
            losses.append(float(total))
            st = rec.japply(st, grads)
        return torch_tree(st.params), losses, draws

    def port_run(draws, **opt_over):
        model, state, step = rec.port(**opt_over)
        losses = []
        for i in range(STEPS):
            state, metrics = step(state, rec.step_inputs(i)[2], draws=draws[i])
            losses.append(float(metrics["loss_total"]))
        return {n: p.detach().clone() for n, p in model.named_parameters()}, losses

    init = torch_tree(rec.variables["params"])
    jax_params, jax_losses, draws = jax_run(rec.variables["params"], True)
    ctl_params, ctl_losses, _ = jax_run(_moved_one_ulp(rec.variables["params"]), False)
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)  # the port's CPU steps take most of this test
    try:
        port_params, port_losses = port_run(draws)
        warm_params, _ = port_run(draws, warmup_iters=OPT["warmup_iters"] + 1)
    finally:
        torch.set_num_threads(threads)
    return dict(init=init, jax=(jax_params, jax_losses), ctl=(ctl_params, ctl_losses),
                port=(port_params, port_losses), warm=warm_params)


def distance(got: dict, ref: dict, init: dict, names=None) -> float:
    """|got - ref| / |ref - init| over the parameters ``names`` (all by
    default), L2 over every entry: the distance between two runs as a share
    of how far the reference run moved."""
    names = sorted(ref) if names is None else names
    num = sum(float(((got[n].double() - ref[n].double()) ** 2).sum()) for n in names)
    den = sum(float(((ref[n].double() - init[n].double()) ** 2).sum()) for n in names)
    return (num / max(den, 1e-300)) ** 0.5


def test_free_running_parameters_stay_within_the_one_ulp_spread(runs):
    init, (jp, _), (cp, _), (pp, _) = runs["init"], runs["jax"], runs["ctl"], runs["port"]
    assert set(pp) == set(jp)
    d_ctl, d_port = distance(cp, jp, init), distance(pp, jp, init)
    rpn = {n: (distance(pp, jp, init, [n]), distance(cp, jp, init, [n])) for n in RPN_REG}
    report = (f"after {STEPS} steps: port {d_port:.3e}, one-ulp control {d_ctl:.3e} of the JAX "
              f"run's movement (limit {MULT:g}x the control); RPN reg (port, control): {rpn}")
    print(report)
    assert d_ctl > 0.0, "the one-ulp control did not move the run at all"
    assert d_port <= MULT * d_ctl, report


def test_free_running_losses_follow_jax(runs):
    (_, jl), (_, pl) = runs["jax"], runs["port"]
    for i, (a, b) in enumerate(zip(pl, jl)):
        assert abs(a - b) <= 2e-4 * max(1.0, abs(b)), (i, a, b)


def test_warmup_off_by_one_fails_the_limit(runs):
    """The control that must fail: the port with ``warmup_iters`` 21."""
    init, (jp, _), (cp, _) = runs["init"], runs["jax"], runs["ctl"]
    d_warm, d_ctl = distance(runs["warm"], jp, init), distance(cp, jp, init)
    print(f"warmup_iters + 1: {d_warm:.4f} of the JAX run's movement ({d_warm / d_ctl:.1f}x the "
          f"one-ulp control)")
    assert d_warm > MULT * d_ctl, (d_warm, d_ctl)


def localise(kw: dict, steps: int, reset: bool) -> list:
    """Step both packages ``steps`` times on the recipe at the model ``kw``
    and return, per step, the losses beyond the single-step tolerance, the
    discrete outputs of the train forward that differ and the largest
    parameter difference of three tensors. With ``reset`` the port's
    weights are set to the JAX run's before each step (equal weights, as
    ``run_both``), else both run free."""
    from attentionshift_torch.convert import load_flax

    rec = Recipe(kw)
    st = rec.jax_state(rec.variables["params"])
    model, state, step = rec.port()
    seen = {}
    fwd = model.forward

    def spy(*a, **k):
        seen["losses"], seen["aux"] = fwd(*a, **k)
        return seen["losses"], seen["aux"]

    model.forward = spy
    rows = []
    for i in range(steps):
        args, key, batch = rec.step_inputs(i)
        if reset:
            load_flax(model, {"params": jax.tree.map(np.asarray, st.params),
                              "batch_stats": rec.variables["batch_stats"]})
        draws = rec.draws(st.params, args, key)
        (_, (jl, jaux)), grads = rec.jgrad(st.params, args, key)
        st = rec.japply(st, grads)
        state, metrics = step(state, batch, draws=draws)
        off = {k: round(float(metrics[k]) - float(v), 6) for k, v in jl.items()
               if abs(float(metrics[k]) - float(v)) > 1e-4 * max(1.0, abs(float(v)))}
        flips = [n for n in ("pseudo_boxes", "pseudo_valid", "pseudo_masks", "best_idx")
                 if not np.array_equal(seen["aux"][n].numpy(), np.asarray(jaux[n]))]
        got, want = {n: p.detach() for n, p in model.named_parameters()}, torch_tree(st.params)
        drift = {n: float((got[n] - want[n]).abs().max())
                 for n in (*RPN_REG[:1], "backbone.blocks.0.attn.qkv.weight")}
        rows.append(dict(step=i, losses_off=off, discrete_off=flips, max_param_diff=drift))
    return rows


if __name__ == "__main__":
    # python tests/test_torch_learning_dynamics.py [--proposals N [--mask-sample-cap M]]
    #     [--reset] [--steps S]
    import argparse
    import json
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description="per-step differences of the free-running runs")
    ap.add_argument("--proposals", type=int, default=KW["num_proposals"])
    ap.add_argument("--mask-sample-cap", type=int, default=None,
                    help="default: KW's, scaled by --proposals / KW's num_proposals")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--reset", action="store_true", help="equal weights before every step")
    a = ap.parse_args()
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    small = dict(num_proposals=a.proposals, rpn_nms_pre=2 * a.proposals,
                 rcnn_samples=min(KW["rcnn_samples"], a.proposals),
                 mask_sample_cap=a.mask_sample_cap
                 or KW["mask_sample_cap"] * a.proposals // KW["num_proposals"])
    kw = KW if a.proposals == KW["num_proposals"] and a.mask_sample_cap is None \
        else dict(KW, **small)
    for row in localise(kw, a.steps, a.reset):
        print(json.dumps(row), flush=True)
