"""The train step's variants of the port against the JAX package's.

Two whole train forwards on the same TINY weights, inputs and draws
(every draw of the JAX step replayed for the port,
``test_torch_support.replay_train_draws``):

- the RepPoints cascade of two heads with ``with_deform_sup``, the MAE
  head and keypoint align in one model (the combination of JAX
  ``tests/test_train.py::test_train_step_with_reppoints_cascade_and_mae_head``
  plus the keypoint head), at batch 2, the port with activation
  checkpointing;
- the EMA teacher (``teacher=`` the teacher's ``backbone_forward``) on
  the tiny model of JAX ``tests/test_mae_ema.py::test_detector_teacher_path``,
  the teacher's weights not the student's.

Each compares the discrete outputs exactly, every loss (2e-4 of
max(1, |loss|), the MIL bag loss 2e-3, ``check_losses_and_aux``) and
every gradient (2e-3 of each tensor's largest entry, ``check_tree``), as
``test_torch_train_step_random.py`` holds the plain step. ``ema_update``
is held against the JAX one over two steps, and the port's teacher-student
step against its definition.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import (TINY, TRAIN_SIZES, blob_inputs, check_losses_and_aux,  # noqa: E402
                                check_tree, jax_model, n_anchors, random_variables,
                                replay_train_draws, torch_model, torch_tree)

NAMES = ("img", "gt_points", "gt_labels", "gt_valid", "img_wh")
CASCADE = dict(with_reppoints_head=True, num_reppoints_head=2, with_deform_sup=True,
               reppoints_num_points=5, reppoints_contour_points=8, with_mae_head=True,
               with_keypoint_align=True)
# the tiny model of the JAX package's teacher test (test_mae_ema.py:56-62)
TEACHER_KW = dict(num_classes=4, embed_dim=48, depth=4, num_heads=6, out_indices=(0, 1, 2, 3),
                  img_size=64, point_tokens=10, cam_layer=3, max_gt=2, cam_stride=4, ccl_iters=8,
                  num_mask_point_gt=4, corr_size=3, mean_shift_times=2, num_semantic_points=2,
                  rpn_channels=32, num_proposals=16, rpn_nms_pre=16, rcnn_samples=8,
                  mask_sample_cap=4, drop_path_rate=0.0)


def jax_step(jmodel, variables, batch: dict, key, kw: dict, teacher=None):
    """The JAX train forward on a numpy ``batch`` with the sampling ``key``
    (and the ``teacher`` variables' backbone outputs): its losses, aux,
    the gradient of the total, and its draws replayed per image."""
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

    jargs = tuple(jnp.asarray(batch[n]) for n in NAMES)
    bs = variables["batch_stats"]
    tout = None if teacher is None else jax.jit(
        lambda v: jmodel.apply(v, jargs[0], method=JDet.backbone_forward))(teacher)

    def loss_fn(params, t):
        losses, aux = jmodel.apply({"params": params, "batch_stats": bs}, *jargs, teacher=t,
                                   rngs={"sampling": key})
        return sum(v for k, v in losses.items() if k.startswith("loss")), (losses, aux)

    (_, (losses, aux)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], tout)
    # the engine's maps: the seed source's CAMs at the layer the student's
    # MIL head picked
    dbg = jax.jit(lambda v: jmodel.apply(v, *jargs, method=JDet.seed_debug,
                                         rngs={"sampling": key}))(teacher or variables)
    cams = np.asarray(dbg["cams"]).transpose(0, 2, 1, 3, 4)  # (B, G, L, Hp, Wp)
    best = np.asarray(aux["best_idx"])
    best_cams = np.take_along_axis(cams, best[:, :, None, None, None], axis=2)[:, :, 0]
    h, w = batch["img"].shape[1:3]
    draws = replay_train_draws(jmodel, variables, key, best_cams, batch["gt_points"],
                               kw.get("seed_map_stride", 4), (h, w), n_anchors(h, w),
                               batch["gt_points"].shape[1] + kw["num_proposals"],
                               kw["rcnn_samples"])
    return jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, aux), grads, draws


def port_step(port, batch: dict, draws, teacher=None):
    """The port's train forward: (losses, aux, gradients by name; an unused
    parameter's gradient is 0, as JAX returns it)."""
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tout = None if teacher is None else teacher.backbone_forward(tb["img"])
    losses, aux = port(*(tb[n] for n in NAMES), teacher=tout, draws=draws)
    total = sum(v for k, v in losses.items() if k.startswith("loss"))
    params = [p for _, p in port.named_parameters()]
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(port.named_parameters(), grads)}
    return {k: v.detach() for k, v in losses.items()}, aux, grads


def _batch(h, w, g, n_valid, make=blob_inputs):
    images = [make(h, w, g, n, seed=i) for i, n in enumerate(n_valid)]
    return {n: np.concatenate([im[j] for im in images]) for j, n in enumerate(NAMES)}


# ---------------------------------------------------------------- cascade


@pytest.fixture(scope="module")
def cascade():
    kw = dict(TINY, max_gt=4, pad_tokens_to=128, drop_path_rate=0.0, **TRAIN_SIZES, **CASCADE)
    batch = _batch(64, 96, 4, (3, 2))
    jm = jax_model(**kw)
    variables = random_variables(jm, tuple(v[:1] for v in batch.values()))
    jlosses, jaux, jgrads, draws = jax_step(jm, variables, batch, jax.random.PRNGKey(3), kw)
    port = torch_model(variables, use_remat=True, **kw)
    losses, aux, grads = port_step(port, batch, draws)
    return dict(jlosses=jlosses, jaux=jaux, jgrads=torch_tree(jgrads), losses=losses, aux=aux,
                grads=grads, params=set(variables["params"]))


def test_cascade_mae_keypoint_step_losses_and_pseudo_labels(cascade):
    """Stage-0 cascade keys unsuffixed, stage 1 suffixed ``_0``, the MAE and
    keypoint losses; every loss and the discrete outputs as JAX's."""
    for k in ("loss_rp_border", "loss_rp_chamfer_sem", "loss_rp_chamfer_contour", "loss_rp_cls",
              "loss_rp_border_0", "loss_rp_chamfer_sem_0", "loss_rp_chamfer_contour_0",
              "loss_rp_cls_0", "loss_mae_rec", "loss_keypoint_align"):
        assert k in cascade["losses"], sorted(cascade["losses"])
    check_losses_and_aux(cascade["losses"], cascade["aux"], cascade["jlosses"], cascade["jaux"])


def test_cascade_mae_keypoint_step_gradients(cascade):
    check_tree(cascade["grads"], cascade["jgrads"], 2e-3, "grad")


def test_cascade_gradients_reach_every_variant_head(cascade):
    """Both cascade heads, the MAE decoder and the keypoint head get a
    gradient."""
    assert {"reppoints_head_0", "reppoints_head_1", "mae_head",
            "keypoint_align_head"} <= cascade["params"]
    for head in ("reppoints_head_0.", "reppoints_head_1.", "mae_head.", "keypoint_align_head."):
        tops = [float(g.abs().max()) for n, g in cascade["grads"].items() if n.startswith(head)]
        assert tops and max(tops) > 0, head


# ---------------------------------------------------------------- teacher


@pytest.fixture(scope="module")
def teacher_case():
    batch = _batch(64, 64, 2, (2,))
    jm = jax_model(**TEACHER_KW)
    args = tuple(batch[n] for n in NAMES)
    student = random_variables(jm, args, seed=0)
    teacher = random_variables(jm, args, seed=1)
    key = jax.random.PRNGKey(1)
    jlosses, jaux, jgrads, draws = jax_step(jm, student, batch, key, TEACHER_KW, teacher=teacher)
    port = torch_model(student, **TEACHER_KW)
    tport = torch_model(teacher, **TEACHER_KW)
    losses, aux, grads = port_step(port, batch, draws, teacher=tport)
    plain = port_step(port, batch, draws)[:2]
    return dict(jlosses=jlosses, jaux=jaux, jgrads=torch_tree(jgrads), losses=losses, aux=aux,
                grads=grads, plain=plain)


def test_teacher_step_losses_and_pseudo_labels(teacher_case):
    t = teacher_case
    check_losses_and_aux(t["losses"], t["aux"], t["jlosses"], t["jaux"])


def test_teacher_step_gradients(teacher_case):
    check_tree(teacher_case["grads"], teacher_case["jgrads"], 2e-3, "grad")


def test_teacher_outputs_feed_the_engine(teacher_case):
    """The control: the student seeding itself on the same draws gives
    other pseudo labels or losses than the teacher's step."""
    losses, aux = teacher_case["plain"]
    differs = [k for k in ("map_fg", "pseudo_boxes", "pseudo_masks")
               if not torch.equal(aux[k], teacher_case["aux"][k])]
    assert differs or float(losses["loss_mil"]) != float(teacher_case["losses"]["loss_mil"])


def test_ema_update_matches_jax_over_two_steps():
    """``ema_update`` over the whole model against the JAX one over the
    variables tree, twice, the student moved in between: equal to f32
    rounding (one ulp of the largest entry)."""
    from attentionshift_torch.train import ema_update
    from attentionshift_tpu.train.ema import ema_update as jema

    kw = dict(TINY, max_gt=4)
    args = blob_inputs(64, 96, 4, 3)
    jm = jax_model(**kw)
    t_vars = random_variables(jm, args, seed=0)
    s_vars = [random_variables(jm, args, seed=s) for s in (1, 2)]
    teacher = torch_model(t_vars, **kw)
    jt = t_vars
    for sv in s_vars:
        jt = jema(jt, sv, momentum=0.9)
        ema_update(teacher, torch_model(sv, **kw), momentum=0.9)
    want = torch_tree(jt["params"])
    got = dict(teacher.named_parameters())
    for name, ref in want.items():
        ulp = float(np.spacing(np.float32(ref.abs().max())))
        assert float((got[name].detach() - ref).abs().max()) <= ulp, name
    np.testing.assert_allclose(teacher.backbone.fpn1_bn.running_var.numpy(),
                               np.asarray(jt["batch_stats"]["backbone"]["fpn1_bn"]["var"]),
                               rtol=1e-6)


def test_train_step_ts_moves_the_teacher_toward_the_updated_student():
    """One step of ``make_train_step_ts``: the teacher's forward builds no
    graph and its outputs seed the step, then every teacher tensor is
    m * teacher + (1 - m) * student-after-the-update, bitwise."""
    import copy

    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.train import (TrainState, build_optimizer, make_train_step_ts,
                                            step_generator)

    kw = dict(TEACHER_KW, drop_path_rate=0.05)
    model = AttnShiftDetector(device="cpu", **kw).init_weights(0)
    teacher = copy.deepcopy(AttnShiftDetector(device="cpu", **kw).init_weights(1))
    t0 = {k: v.clone() for k, v in teacher.state_dict().items()}
    seen = []
    inner = teacher.backbone_forward

    def spy(img):
        out = inner(img)
        seen.append(out)
        return out

    teacher.backbone_forward = spy
    batch = {k: torch.from_numpy(v) for k, v in _batch(64, 64, 2, (2,)).items()}
    opt = build_optimizer(model, base_lr=1e-3, steps_per_epoch=10, warmup_iters=0, depth=4)
    step = make_train_step_ts(model, momentum=0.9)
    state, teacher, metrics = step(TrainState.create(model, opt), teacher, batch,
                                   generator=step_generator(0, 0, "cpu"))
    assert len(seen) == 1 and not seen[0]["last_feat"].requires_grad
    assert all(np.isfinite(float(v)) for v in metrics.values())
    student = model.state_dict()
    for name, t in teacher.state_dict().items():
        if t.is_floating_point():
            assert torch.equal(t, t0[name] * 0.9 + student[name] * (1.0 - 0.9)), name
    assert not torch.equal(teacher.mil_head.fc1.weight, t0["mil_head.fc1.weight"])
