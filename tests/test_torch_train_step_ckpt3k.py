"""The whole train step of the port against the JAX package on the
trained fixture ``tools/fixtures/ckpt3k`` (ViT-S width, every subtree
converted), f32, the disc scene at 128x192, ``drop_path_rate=0``, the
JAX draws replayed, no activation checkpointing on the port's side (the
random-weights file runs with it). Trained attention gives sharp CAMs
and real proposals, so the selections (MIL layer, NMS, samplers) are
exercised on data unlike the random model's. Compared as in
``test_torch_train_step_random``: discrete outputs exactly, losses,
every gradient, and the parameters and Adam moments over two steps.

Gradients here are held to 1e-2 of each tensor's largest entry (the
random-weights file: 2e-3): the trained MIL head's bag sums sit at the
clip of log(1 - x), which scales f32 rounding of the saturated sums (the
reason for ``ABS_TOL["loss_mil"]``), and that loss reaches every backbone
parameter. Where a bag sum sits within rounding of the clip, the clip's
gradient is 0 on one side and 1 / 1e-6 on the other, so single entries of
the MIL head's own gradients differ by more: those tensors are held to
1e-2 of the largest entry of the whole MIL head. First moments as the
gradients, second moments twice that.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_support import (TRAIN_OPT, TrainCase, adam_state, check_step_outputs,  # noqa: E402
                                check_tree, run_both, torch_tree)


def test_two_train_steps_match_jax_on_ckpt3k():
    case = TrainCase("ckpt3k", port_remat=False)
    state, opt, jstate, seen = run_both(case, dict(TRAIN_OPT, depth=12), accumulate_steps=1,
                                        n_steps=2)
    check_step_outputs(seen, grad_rel=1e-2, group="mil_head.")
    adam = adam_state(jstate.opt_state)
    assert state.step == int(jstate.step) == 2 and opt.count == int(adam.count) == 2
    check_tree(dict(zip(opt.names, opt.mu)), torch_tree(adam.mu), 1e-2, "mu", "mil_head.")
    check_tree(dict(zip(opt.names, opt.nu)), torch_tree(adam.nu), 2e-2, "nu", "mil_head.")
