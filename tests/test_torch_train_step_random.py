"""The whole train step of the port against the JAX package, random
weights at a narrow width (embed 128, 4 blocks, head dim 64), f32, the
disc scene, ``drop_path_rate=0``, the JAX draws replayed into the port.

The JAX side differentiates ``AttnShiftDetector.__call__`` with respect
to the ``params`` subtree and updates it with the package's own
``build_optimizer`` and ``TrainState``; the port runs
``make_train_step`` with activation checkpointing ON. Compared: the
discrete outputs exactly, the loss dict, every parameter's gradient,
and parameters plus Adam moments after two steps.

Tolerances. Gradients: 2e-3 of each tensor's largest entry (f32 sums in
another order, through selections that both sides make alike). Adam's
first moment as the gradients; the second moment is quadratic: 4e-3.
Parameters are compared twice: the port's own step within 2.2 lr of the
JAX parameters (where a gradient is rounding noise, the sign of Adam's
lr * m / sqrt(v) is noise too), and a second port optimizer fed the JAX
gradients within 1e-3 lr and 1e-5 on the moments (the optimizer alone).
So that the noise does not feed the next step's gradients, the port
takes over the JAX parameters after each compared update; its moments
stay its own.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import (TRAIN_OPT, TrainCase, adam_state, check_optimizer,  # noqa: E402
                                check_step_outputs, check_tree, run_both, torch_tree)

OPT = dict(TRAIN_OPT, depth=4)


@pytest.fixture(scope="module")
def case():
    return TrainCase("random", port_remat=True)


def test_two_train_steps_match_jax(case):
    state, opt, jstate, seen = run_both(case, OPT, accumulate_steps=1, n_steps=2)
    check_step_outputs(seen)
    adam = adam_state(jstate.opt_state)
    assert state.step == int(jstate.step) == 2 and opt.count == int(adam.count) == 2
    check_tree(dict(zip(opt.names, opt.mu)), torch_tree(adam.mu), 2e-3, "mu")
    check_tree(dict(zip(opt.names, opt.nu)), torch_tree(adam.nu), 4e-3, "nu")


def test_accumulated_train_steps_match_jax(case):
    """accumulate_steps=2: two calls, one update from the mean gradient."""
    state, opt, jstate, seen = run_both(case, OPT, accumulate_steps=2, n_steps=2)
    adam = adam_state(jstate.opt_state)
    assert state.step == int(jstate.step) == 2
    assert opt.count == int(adam.count) == 1 and opt.mini_step == 0
    check_tree(dict(zip(opt.names, opt.mu)), torch_tree(adam.mu), 2e-3, "mu")
    check_tree(dict(zip(opt.names, opt.nu)), torch_tree(adam.nu), 4e-3, "nu")
    start = torch_tree(case.variables["params"])
    assert any(not torch.equal(p.detach(), start[n]) for n, p in case.port.named_parameters())


def test_nonfinite_gradient_is_skipped_and_counted_as_in_jax(case):
    """One call with a NaN in one gradient: parameters and moments stay,
    the three counters move as optax's; the next finite call resets the
    run counter and updates."""
    from attentionshift_torch.train import build_optimizer
    from attentionshift_tpu.train import TrainState as JState
    from attentionshift_tpu.train import build_optimizer as jbuild

    params = case.variables["params"]
    case.set_params(params)
    key = jax.random.PRNGKey(10)
    (_, _), jgrads = case.jgrad(params, key)
    tgrads = torch_tree(jgrads)
    opt = build_optimizer(case.port, accumulate_steps=1, **OPT)
    jstate = JState.create(params, jbuild(params, accumulate_steps=1, **OPT))
    bad_j = jax.tree.map(lambda x: x, jgrads)
    bad_j["mil_head"]["fc1"]["bias"] = bad_j["mil_head"]["fc1"]["bias"].at[0].set(jnp.nan)
    bad_t = {k: v.clone() for k, v in tgrads.items()}
    bad_t["mil_head.fc1.bias"][0] = float("nan")
    before = {n: p.detach().clone() for n, p in case.port.named_parameters()}

    jstate = jstate.apply_gradients(bad_j)
    changed = opt.step([bad_t[n] for n in opt.names])
    assert not changed and opt.count == 0
    assert (opt.notfinite_count, opt.last_finite, opt.total_notfinite) == (
        int(jstate.opt_state.notfinite_count), bool(jstate.opt_state.last_finite),
        int(jstate.opt_state.total_notfinite)) == (1, False, 1)
    for n, p in case.port.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
    assert all(float(m.abs().max()) == 0 for m in opt.mu)

    jstate = jstate.apply_gradients(jgrads)
    assert opt.step([tgrads[n] for n in opt.names])
    assert (opt.notfinite_count, opt.last_finite, opt.total_notfinite) == (
        int(jstate.opt_state.notfinite_count), bool(jstate.opt_state.last_finite),
        int(jstate.opt_state.total_notfinite)) == (0, True, 1)
    check_optimizer(opt, jstate, OPT["base_lr"])
