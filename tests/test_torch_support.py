"""Shared helpers of the PyTorch-port parity tests, and the test of the
kernel build's cache key (the one test here).

The parity tests feed the same numpy inputs, made from a seed, through a
JAX function and its ``attentionshift_torch`` counterpart on the CPU.
Models are compared on the same weights: random flax variables built
from the model's own parameter shapes, or the committed trained fixture
``tools/fixtures/ckpt3k``, converted with ``attentionshift_torch.convert``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT3K = os.path.join(REPO, "tools", "fixtures", "ckpt3k")

# ViT-S width of configs/attnshift_voc12aug.py (the ckpt3k geometry)
VITS = dict(num_classes=20, embed_dim=384, depth=12, num_heads=6, point_tokens=100, cam_layer=7)
# narrow random-weight model: head dim 64 like ViT-S, 4 blocks, 3 captured
TINY = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, point_tokens=16, cam_layer=3,
            out_indices=(0, 1, 2, 3))


def drop_weights(*roots) -> None:
    """Delete the checkpoints and tensor files (``*epoch_*``, ``*.pt``,
    ``*.pt2``) under each root once a test has read them: a TINY train
    state is ~0.4 GB, and pytest keeps the basetemps of its last three
    runs."""
    import pathlib

    for root in roots:
        root = pathlib.Path(root)
        files = [root] if root.is_file() else [
            f for pattern in ("*epoch_*", "*.pt", "*.pt2") for f in root.rglob(pattern)]
        for f in files:
            if f.is_file():
                f.unlink()


def inputs(h: int, w: int, g: int, n_valid: int, seed: int = 0):
    """numpy (img, gt_points, gt_labels, gt_valid, img_wh) for batch 1."""
    rs = np.random.RandomState(seed)
    img = rs.randn(1, h, w, 3).astype(np.float32)
    pts = (rs.rand(1, g, 2) * [w * 0.8, h * 0.8] + [w * 0.1, h * 0.1]).astype(np.float32)
    lbl = rs.randint(0, 20, (1, g)).astype(np.int32)
    valid = np.asarray([[True] * n_valid + [False] * (g - n_valid)])
    wh = np.asarray([[float(w), float(h)]], np.float32)
    return img, pts, lbl, valid, wh


def blob_inputs(h: int, w: int, g: int, n_valid: int, seed: int = 0):
    """Like ``inputs``, on an image of ``n_valid`` bright discs (the
    ckpt3k training corpus's kind of scene), one annotated point per
    disc, so the instances' maps differ: instances whose refined maps
    agree to float rounding would make the winner-take-all selection of
    Stage B a coin toss between the two packages."""
    rs = np.random.RandomState(seed)
    img = (rs.randn(1, h, w, 3) * 0.1).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    pts = (rs.rand(1, g, 2) * [w * 0.8, h * 0.8] + [w * 0.1, h * 0.1]).astype(np.float32)
    cols = np.linspace(0.1, 0.9, n_valid)
    for j in range(n_valid):
        cx, cy = w * cols[j], h * (0.3 + 0.4 * rs.rand())
        r = min(h, w) * (0.15 + 0.1 * rs.rand())
        img[0][(xx - cx) ** 2 + (yy - cy) ** 2 < r * r, j % 3] += 2.5
        pts[0, j] = (cx, cy)
    lbl = (np.arange(g) % 3).astype(np.int32)[None]
    valid = np.asarray([[True] * n_valid + [False] * (g - n_valid)])
    wh = np.asarray([[float(w), float(h)]], np.float32)
    return img, pts, lbl, valid, wh


def jax_model(**kw):
    from attentionshift_tpu.models.detector import AttnShiftDetector

    return AttnShiftDetector(use_remat=False, **kw)


def random_variables(model, args, seed: int = 0, scale: float = 0.05):
    """Flax variables of the whole model (the train forward's parameter
    tree) filled from numpy: N(0, scale) matrices/tokens/biases,
    1 + N(0, 0.1) norm scales, positive running variances."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: model.init({"params": key, "sampling": key, "dropout": key},
                           *map(jnp.asarray, args)))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (scale * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.tree.map(lambda s: s, shapes))


def ckpt3k_variables():
    """The committed ckpt3k fixture restored as in bench.py, f32, every
    subtree (backbone, MIL head, neck, RPN, box and mask heads)."""
    from attentionshift_tpu.train.checkpoint import restore_params

    return jax.tree.map(lambda x: np.asarray(x, np.float32), restore_params(CKPT3K))


def torch_model(variables, **kw):
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.models import AttnShiftDetector

    model = AttnShiftDetector(device="cpu", **kw)
    return load_flax(model, jax.tree.map(np.asarray, variables))


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def replay_draws(model, variables, jdebug, key, gt_points, stride: int, img_hw):
    """The JAX package's random draws of one ``seed_pseudo_gt`` call,
    replayed from its key tree for the port (batch 1):
    ``split(rng, b)`` (detector.py:478) -> ``split`` (engine.py:151) ->
    ``sample_fgbg_points`` (refine.py:228) for the Stage-B seed points,
    ``split(k_points, g)`` + ``gumbel`` (refine.py:373, points.py:95)
    for the mask-point noise."""
    from attentionshift_tpu.ops.image import resize
    from attentionshift_tpu.pseudo.cam import norm_attns
    from attentionshift_tpu.pseudo.refine import sample_fgbg_points

    rng = model.apply(variables, method=lambda m: m.make_rng("sampling"),
                      rngs={"sampling": key})
    k_img = jax.random.split(rng, 1)[0]
    k_refine, k_points = jax.random.split(k_img)
    h, w = img_hw
    cams = resize(jnp.asarray(jdebug["best_cams"][0]), (h // stride, w // stride))
    pfg, pbg = sample_fgbg_points(k_refine, norm_attns(cams), jnp.asarray(gt_points[0]),
                                  0.2, 0.1, 20, stride=stride)
    g = gt_points.shape[1]
    n = (h // stride) * (w // stride)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (n,)))
                       for k in jax.random.split(k_points, g)])
    return [dict(points_fg=torch.from_numpy(np.array(pfg)),
                 points_bg=torch.from_numpy(np.array(pbg)),
                 gumbel=torch.from_numpy(gumbel))]


def close(a, b, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


# keys compared exactly: integers, and coordinates picked from integer grids
EXACT = {"assigned", "best_attn_idx", "token_of_gt", "mask_points_labels",
         "semantic_centers_valid", "pseudo_gt_masks", "pseudo_gt_labels", "pseudo_gt_valid",
         "candidate_boxes", "pseudo_gt_bboxes", "mask_points_coords", "semantic_centers"}
# absolute tolerances of the float keys, relative to the key's largest
# magnitude (f32 sums in another order through the backbone), except:
# map_cos_fg is max-normalised maps (1e-4), and the MIL bag loss takes
# log(1 - x) of bag sums clipped at 1 - 1e-6, which scales f32 rounding
# of saturated sums by up to 1e6 (2e-3)
REL_TOL = {"outputs_class": 1e-5, "outputs_coord": 1e-5, "rollout_rows": 1e-5, "cams": 1e-5,
           "best_cams": 1e-5, "vit_feat": 1e-5}
ABS_TOL = {"map_cos_fg": 1e-4, "loss_mil": 2e-3}


def check_slice(weights: str, cam_stride: int, map_stride: int, seed: int = 0):
    """Run ``seed_debug`` and ``seed_pseudo_gt`` of both packages on the
    same weights, inputs and (replayed) draws and compare every key."""
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

    if weights == "random":
        kw = dict(TINY)
        h, w = 64, 96
        make = inputs
    else:
        kw = dict(VITS)
        h, w = 128, 192
        make = blob_inputs
    g = 4
    kw.update(max_gt=g, cam_stride=cam_stride, seed_map_stride=map_stride, pad_tokens_to=128)
    args = make(h, w, g, 3, seed=seed)
    model = jax_model(**kw)
    variables = random_variables(model, args) if weights == "random" else ckpt3k_variables()
    key = jax.random.PRNGKey(seed + 3)
    jargs = tuple(map(jnp.asarray, args))
    want = {}
    for method in ("seed_debug", "seed_pseudo_gt"):
        fn = jax.jit(lambda v, k, m=getattr(JDet, method): model.apply(
            v, *jargs, method=m, rngs={"sampling": k}))
        want[method] = jax.tree.map(np.asarray, fn(variables, key))
    draws = replay_draws(model, variables, want["seed_debug"], key, args[1], map_stride, (h, w))
    port = torch_model(variables, **kw)
    targs = to_torch(*args)
    got = {"seed_debug": port.seed_debug(*targs, draws=draws),
           "seed_pseudo_gt": port.seed_pseudo_gt(*targs, draws=draws)}
    for method in got:
        assert set(got[method]) == set(want[method]), method
        for name, ref in want[method].items():
            out = got[method][name].numpy()
            what = f"{method}[{name}]"
            assert out.shape == ref.shape, what
            if name in EXACT:
                np.testing.assert_array_equal(out, ref, err_msg=what)
            elif name in ABS_TOL:
                close(out, ref, ABS_TOL[name], what=what)
            else:
                close(out, ref, REL_TOL[name] * max(float(np.abs(ref).max()), 1.0), what=what)
    # the padded instance carries the padding contract
    pg = got["seed_pseudo_gt"]
    assert (pg["mask_points_labels"][0, 3] == 2).all()
    assert (pg["pseudo_gt_masks"][0, 3] == 0).all()


# ------------------------------------------------------------- train step
# small RPN/RCNN sizes for the whole-step tests (both packages take them)
TRAIN_SIZES = dict(num_proposals=100, rpn_nms_pre=200, rcnn_samples=64, mask_sample_cap=16)
# discrete outputs of the train forward, compared exactly
AUX_EXACT = ("pseudo_boxes", "pseudo_valid", "pseudo_masks", "best_idx", "semantic_centers",
             "semantic_valid")


def engine_draws(rng, best_cams, gt_points, stride: int, img_hw, i: int = 0):
    """``replay_draws`` from the engine's own key, for image ``i`` of the
    batch (the engine splits its key over the batch)."""
    from attentionshift_tpu.ops.image import resize
    from attentionshift_tpu.pseudo.cam import norm_attns
    from attentionshift_tpu.pseudo.refine import sample_fgbg_points

    b = gt_points.shape[0]
    k_refine, k_points = jax.random.split(jax.random.split(rng, b)[i])
    h, w = img_hw
    cams = resize(jnp.asarray(best_cams[i]), (h // stride, w // stride))
    pfg, pbg = sample_fgbg_points(k_refine, norm_attns(cams), jnp.asarray(gt_points[i]),
                                  0.2, 0.1, 20, stride=stride)
    g = gt_points.shape[1]
    n = (h // stride) * (w // stride)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (n,)))
                       for k in jax.random.split(k_points, g)])
    return dict(points_fg=torch.from_numpy(np.array(pfg)), points_bg=torch.from_numpy(np.array(pbg)),
                gumbel=torch.from_numpy(gumbel))


def replay_train_draws(model, variables, key, best_cams, gt_points, stride, img_hw, n_anchors,
                       n_rois, n_samples):
    """Every random draw of one JAX train forward, per image of the batch,
    for the port: ``make_rng("sampling")`` -> ``split(rng, 3)``
    (detector.py:253) into the RPN sampler (rpn.py:92, assign.py:116), the
    RCNN sampler (detector.py:596, assign.py:144; its ordering score reuses
    the positives' key, detector.py:609), the mask pick (detector.py:642,649)
    and the engine; each of them splits its key over the batch. The train
    variants of ``model`` add (detector.py:300-358): per cascade stage i of
    ``k_rp = fold_in(rng, 7)`` the contour points' Gumbel noise
    (``split(fold_in(k_rp, i), b)``, then one key per mask, reppoints.py:66)
    and, for i > 0, the background supplement's (``split(fold_in(k_rp,
    100 + i), b)``, reppoints.py:258); the MAE masking uniforms
    ``uniform(fold_in(rng, 11), (b, N))`` (mae_head.py:66)."""
    rng = model.apply(variables, method=lambda m: m.make_rng("sampling"), rngs={"sampling": key})
    k_rpn, k_rcnn, k_engine = jax.random.split(rng, 3)
    u = lambda k, n: torch.from_numpy(np.array(jax.random.uniform(k, (n,))))  # noqa: E731
    gumbel = lambda k, n: torch.from_numpy(np.array(jax.random.gumbel(k, (n,))))  # noqa: E731
    b, g = gt_points.shape[:2]
    h, w = img_hw
    k_rp = jax.random.fold_in(rng, 7)
    n_rp = model.num_reppoints_head if model.with_reppoints_head else 0
    mae = (np.array(jax.random.uniform(jax.random.fold_in(rng, 11), (b, (h // 16) * (w // 16))))
           if model.with_mae_head else None)
    out = []
    for i in range(b):
        rp, rn = jax.random.split(jax.random.split(k_rpn, b)[i])
        cp, cn = jax.random.split(jax.random.split(k_rcnn, b)[i])
        km = jax.random.split(jax.random.fold_in(k_rcnn, 1), b)[i]
        draws = engine_draws(k_engine, best_cams, gt_points, stride, img_hw, i)
        draws.update(rpn_u_pos=u(rp, n_anchors), rpn_u_neg=u(rn, n_anchors),
                     rcnn_u_pos=u(cp, n_rois), rcnn_u_neg=u(cn, n_rois), mask_u=u(km, n_samples))
        for st in range(n_rp):
            kc = jax.random.split(jax.random.fold_in(k_rp, st), b)[i]
            draws[f"rp_contour_{st}"] = torch.stack([gumbel(k, h * w)
                                                     for k in jax.random.split(kc, g)])
            if st > 0:
                draws[f"rp_bg_{st}"] = gumbel(
                    jax.random.split(jax.random.fold_in(k_rp, 100 + st), b)[i], h * w)
        if mae is not None:
            draws["mae_noise"] = torch.from_numpy(mae[i])
        out.append(draws)
    return out


class TrainCase:
    """Both packages' detectors on the same weights and inputs, with the
    JAX train forward's value-and-grad jitted once."""

    def __init__(self, weights: str, port_remat: bool):
        from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

        if weights == "random":
            kw, (h, w), make = dict(TINY), (64, 96), blob_inputs
        else:
            kw, (h, w), make = dict(VITS), (128, 192), blob_inputs
        g = 4
        kw.update(max_gt=g, pad_tokens_to=128, drop_path_rate=0.0, **TRAIN_SIZES)
        self.args = make(h, w, g, 3, seed=0)
        self.hw, self.g, self.kw = (h, w), g, kw
        self.jmodel = jax_model(**kw)
        variables = (random_variables(self.jmodel, self.args) if weights == "random"
                     else ckpt3k_variables())
        self.variables = jax.tree.map(jnp.asarray, variables)
        jargs = tuple(map(jnp.asarray, self.args))
        bs = self.variables["batch_stats"]

        def loss_fn(params, key):
            losses, aux = self.jmodel.apply({"params": params, "batch_stats": bs}, *jargs,
                                            rngs={"sampling": key})
            total = sum(v for k, v in losses.items() if k.startswith("loss"))
            return total, (losses, aux)

        self.jgrad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        self.jdebug = jax.jit(lambda v, k: self.jmodel.apply(
            v, *jargs, method=JDet.seed_debug, rngs={"sampling": k}))
        self.port = torch_model(variables, use_remat=port_remat, **kw)
        self.targs = to_torch(*self.args)
        sizes = [(h // s, w // s) for s in (4, 8, 16, 32)]
        sizes.append((-(-sizes[-1][0] // 2), -(-sizes[-1][1] // 2)))
        self.n_anchors = 3 * sum(a * b for a, b in sizes)

    def set_params(self, params):
        """Load a flax ``params`` tree into the port (batch stats kept)."""
        from attentionshift_torch.convert import load_flax

        load_flax(self.port, {"params": jax.tree.map(np.asarray, params),
                              "batch_stats": jax.tree.map(np.asarray, self.variables["batch_stats"])})

    def draws(self, params, key):
        v = {"params": params, "batch_stats": self.variables["batch_stats"]}
        dbg = self.jdebug(v, key)
        return replay_train_draws(
            self.jmodel, v, key, np.asarray(dbg["best_cams"]), self.args[1],
            self.kw.get("seed_map_stride", 4), self.hw, self.n_anchors,
            self.g + self.kw["num_proposals"], self.kw["rcnn_samples"])

    def batch(self):
        return dict(zip(("img", "gt_points", "gt_labels", "gt_valid", "img_wh"), self.targs))


def n_anchors(h: int, w: int) -> int:
    """RPN anchors of an (h, w) canvas: 3 per cell of the five FPN levels."""
    sizes = [(h // s, w // s) for s in (4, 8, 16, 32)]
    sizes.append((-(-sizes[-1][0] // 2), -(-sizes[-1][1] // 2)))
    return 3 * sum(a * b for a, b in sizes)


def jax_train_reference(jmodel, variables, batch: dict, key, kw: dict):
    """The JAX train forward's losses and the gradient of their sum on a
    numpy ``batch`` (any batch size) with the sampling ``key``, and its
    draws replayed per image for the port: (losses, grads, draws)."""
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

    names = ("img", "gt_points", "gt_labels", "gt_valid", "img_wh")
    jargs = tuple(jnp.asarray(batch[n]) for n in names)
    bs = variables["batch_stats"]

    def loss_fn(params):
        losses, _ = jmodel.apply({"params": params, "batch_stats": bs}, *jargs,
                                 rngs={"sampling": key})
        return sum(v for k, v in losses.items() if k.startswith("loss")), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    dbg = jax.jit(lambda v: jmodel.apply(v, *jargs, method=JDet.seed_debug,
                                         rngs={"sampling": key}))(variables)
    h, w = batch["img"].shape[1:3]
    draws = replay_train_draws(jmodel, variables, key, np.asarray(dbg["best_cams"]),
                               batch["gt_points"], kw.get("seed_map_stride", 4), (h, w),
                               n_anchors(h, w), batch["gt_points"].shape[1] + kw["num_proposals"],
                               kw["rcnn_samples"])
    return {k: float(v) for k, v in losses.items()}, grads, draws


def torch_tree(params) -> dict:
    """A flax ``params``-shaped tree (gradients, Adam moments) under the
    port's parameter names and layouts."""
    from attentionshift_torch.convert import flax_to_torch

    return flax_to_torch({"params": jax.tree.map(np.asarray, params)})


def check_losses_and_aux(losses, aux, jlosses, jaux, tol=2e-4):
    """Discrete outputs exactly, then every loss: ``tol`` relative to the
    larger of 1 and the value (f32 sums in another order through the
    model; the MIL bag loss as ``ABS_TOL`` explains)."""
    for name in AUX_EXACT:
        np.testing.assert_array_equal(aux[name].numpy(), np.asarray(jaux[name]), err_msg=name)
    close(aux["map_fg"], jaux["map_fg"], ABS_TOL["map_cos_fg"], what="map_fg")
    assert set(losses) == set(jlosses)
    for name, ref in jlosses.items():
        ref = float(ref)
        t = ABS_TOL["loss_mil"] if name == "loss_mil" else tol * max(1.0, abs(ref))
        close(float(losses[name]), ref, t, what=name)


def check_tree(got: dict, want: dict, rel: float, what: str, group: str | None = None):
    """Per tensor: ``rel`` times the reference's largest magnitude, and
    never below 1e-6 of the whole tree's largest (a tensor whose gradient
    is zero analytically holds only rounding noise). Tensors whose name
    starts with ``group`` share one scale, the group's largest."""
    assert set(got) == set(want), what
    floor = 1e-6 * max(float(v.abs().max()) for v in want.values())
    shared = max([float(v.abs().max()) for n, v in want.items() if group and n.startswith(group)],
                 default=0.0)
    for name, ref in want.items():
        ref = ref.numpy()
        top = shared if group and name.startswith(group) else float(np.abs(ref).max())
        close(got[name].numpy(), ref, rel * top + floor, what=f"{what}[{name}]")


# no warmup and a large lr, so that an update is far above f32 rounding
TRAIN_OPT = dict(base_lr=1e-3, steps_per_epoch=100, warmup_iters=0)


def adam_state(opt_state):
    import optax

    found = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def run_both(case, opt_kw, accumulate_steps, n_steps):
    """n_steps of both packages from the case's initial weights; yields
    per step (port metrics, port grads, jax losses, jax grads, jax aux)."""
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step
    from attentionshift_tpu.train import TrainState as JState
    from attentionshift_tpu.train import build_optimizer as jbuild

    params = case.variables["params"]
    case.set_params(params)
    jstate = JState.create(params, jbuild(params, accumulate_steps=accumulate_steps, **opt_kw))
    opt = build_optimizer(case.port, accumulate_steps=accumulate_steps, **opt_kw)
    state = TrainState.create(case.port, opt)
    step_fn = make_train_step(case.port)
    # a second port optimizer over a copy of the parameters, fed the JAX
    # gradients: the optimizer alone against optax, free of gradient noise
    twin = build_optimizer([(n, p.detach().clone()) for n, p in case.port.named_parameters()],
                           accumulate_steps=accumulate_steps, **opt_kw)
    seen = []
    grads_box = []
    orig = opt.step
    opt.step = lambda grads: (grads_box.append([g.clone() for g in grads]), orig(grads))[1]
    for i in range(n_steps):
        key = jax.random.PRNGKey(10 + i)
        draws = case.draws(jstate.params, key)
        (_, (jlosses, jaux)), jgrads = case.jgrad(jstate.params, key)
        jstate = jstate.apply_gradients(jgrads)
        same = torch_tree(jgrads)
        twin.step([same[n] for n in twin.names])
        check_optimizer(twin, jstate, opt_kw["base_lr"])
        model_out = {}
        fwd = case.port.forward

        def spy(*a, **k):
            model_out["losses"], model_out["aux"] = fwd(*a, **k)
            return model_out["losses"], model_out["aux"]

        case.port.forward = spy
        count = opt.count
        try:
            state, metrics = step_fn(state, case.batch(), draws=draws)
        finally:
            del case.port.forward
        grads = dict(zip(opt.names, grads_box[-1]))
        if opt.count > count:
            check_params(case, opt, jstate, opt_kw["base_lr"])
        case.set_params(jstate.params)
        seen.append((metrics, model_out["aux"], grads, jlosses, jgrads, jaux))
    return state, opt, jstate, seen


def check_params(case, opt, jstate, base_lr):
    """The port's parameters after one update of its own step against the
    JAX ones: within 2.2 lr everywhere. An Adam update is lr * m / sqrt(v):
    where a gradient is rounding noise (far below its tensor's scale, or
    zero analytically) its sign is noise and the update may differ by the
    whole lr, so the tight comparison is ``check_optimizer``'s, on equal
    gradients."""
    want = torch_tree(jstate.params)
    got = {n: p.detach() for n, p in case.port.named_parameters()}
    assert set(got) == set(want)
    for name, ref in want.items():
        lr = base_lr * opt.scales[opt.names.index(name)]
        assert float((got[name] - ref).abs().max()) <= 2.2 * lr, name


def check_optimizer(opt, jstate, base_lr):
    """A port optimizer that was fed the JAX gradients against optax:
    parameters within 1e-3 of the step (lr), moments within 1e-5 of each
    tensor's largest entry (f32 rounding only)."""
    want = torch_tree(jstate.params)
    for name, p in zip(opt.names, opt.params):
        lr = base_lr * opt.scales[opt.names.index(name)]
        assert float((p - want[name]).abs().max()) <= 1e-3 * lr + 1e-7, name
    adam = adam_state(jstate.opt_state)
    assert opt.count == int(adam.count)
    check_tree(dict(zip(opt.names, opt.mu)), torch_tree(adam.mu), 1e-5, "mu (same grads)")
    check_tree(dict(zip(opt.names, opt.nu)), torch_tree(adam.nu), 1e-5, "nu (same grads)")


def check_step_outputs(seen, grad_rel=2e-3, group=None):
    """Every compared step of ``run_both``: discrete outputs exactly, the
    losses and their total, every parameter's gradient (``grad_rel`` of
    each tensor's largest entry), none of them identically zero."""
    for metrics, aux, grads, jlosses, jgrads, jaux in seen:
        losses = {k: v for k, v in metrics.items() if k != "loss_total"}
        check_losses_and_aux(losses, aux, jlosses, jaux)
        total = sum(float(v) for k, v in jlosses.items() if k.startswith("loss"))
        assert abs(float(metrics["loss_total"]) - total) <= 2e-4 * max(1.0, abs(total)) + 2e-3
        check_tree(grads, torch_tree(jgrads), grad_rel, "grad", group)
    assert all(float(g.abs().max()) > 0 for g in seen[0][2].values())


def test_build_digest_covers_included_headers(tmp_path):
    """The built library's name hashes a source and every header it
    includes: editing ``csrc/hopper.cuh`` renames the backward pair's
    library (and no stale one is loaded), editing another source does not."""
    import shutil

    from attentionshift_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    src = str(csrc / "attention_bwd.cu")
    assert '#include "hopper.cuh"' in open(src).read()
    before = _build._digest(src)
    assert before == _build._digest(os.path.join(_build._CSRC, "attention_bwd.cu"))
    with open(csrc / "ccl.cu", "a") as fh:
        fh.write("// unrelated edit\n")
    assert _build._digest(src) == before
    with open(csrc / "hopper.cuh", "a") as fh:
        fh.write("// header edit\n")
    after = _build._digest(src)
    assert after != before
    with open(src, "a") as fh:
        fh.write("// source edit\n")
    assert _build._digest(src) not in (before, after)


def test_build_digest_covers_define_overrides():
    """A source built with ``-D`` overrides of its design constants gets a
    library of its own: each set of overrides names a different file, and
    the same set names the same file again."""
    from attentionshift_torch.ops import _build

    plain = _build._target("attention")[1]
    three = _build._target("attention", ("FWD_STAGES=3",))[1]
    assert plain == _build._target("attention", ())[1]
    assert three == _build._target("attention", ("FWD_STAGES=3",))[1]
    assert len({plain, three, _build._target("attention", ("FWD_STAGES=5",))[1]}) == 3
    assert all(os.path.dirname(p) == _build.BUILD_DIR for p in (plain, three))


# ------------------------------------------------------------- evaluation

# TINY with test-time sizes; the lowered score floor puts detections past the
# seeded random heads
EVAL_KW = dict(TINY, max_gt=4, num_proposals=48, rpn_nms_pre=200, rcnn_samples=32,
               mask_sample_cap=16, test_max_per_img=20, test_score_thr=0.02)
AUG_SCALES = [(96, 160), (64, 128)]  # two scales (x flip) of the 6 x 2 protocol, cut for the CPU
# boxes: 1e-3 px plus 1e-5 of the coordinate, as for simple_test
# (test_torch_infer.py: f32 backbone noise times anchor size)
BOX_TOL = dict(atol=1e-3, rtol=1e-5)
# scores and mask probabilities: 1e-4, as for simple_test's; each is a mean
# of the per-augmentation values that simple_test's tests hold to 1e-4
PROB_TOL = 1e-4


def eval_models():
    """Both packages' detectors on the same TINY weights (scale 0.05) and
    a JAX ``AugTester`` of ``AUG_SCALES`` with flip, for a module-scoped
    fixture, so that each input shape compiles once."""
    from attentionshift_tpu.eval.aug_test import AugTester as JAugTester

    jmodel = jax_model(**EVAL_KW)
    variables = random_variables(jmodel, inputs(64, 96, 4, 3))
    port = torch_model(variables, **EVAL_KW)
    return dict(jmodel=jmodel, variables=variables, port=port,
                jaug=JAugTester(jmodel, variables, scales=AUG_SCALES, flip=True))


# ------------------------------------------------------- synthetic datasets

# image sizes (h, w) of the synthetic trees: one landscape, one portrait
TREE_SIZES = ((120, 160), (160, 120))


def _palette():
    pal = []
    for i in range(256):
        pal += [i, (i * 37) % 256, (i * 91) % 256]
    return pal


def _blobs(rs, h: int, w: int, n: int):
    """``n`` disjoint elliptic instance masks (n, h, w) bool with a
    one-pixel ring around each (VOC draws instance boundaries as 255)."""
    yy, xx = np.mgrid[:h, :w]
    masks, rings = [], []
    for j in range(n):
        cx = w * (j + 0.5) / n + rs.uniform(-3, 3)
        cy = h * rs.uniform(0.35, 0.65)
        ax, ay = w / (2.5 * n), h * rs.uniform(0.15, 0.3)
        d = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2
        masks.append(d < 1.0)
        rings.append((d >= 1.0) & (d < 1.25))
    return np.stack(masks), np.stack(rings)


def voc_tree(root, sizes=TREE_SIZES, seed: int = 0) -> dict:
    """A VOC2012-layout tree under ``root`` (a ``pathlib.Path``): JPEG
    images with 2-3 blob instances each, ``SegmentationObject`` and
    ``SegmentationClass`` palette PNGs (instance boundaries 255),
    ``ImageSets/Segmentation/val.txt`` and a point-annotation json for
    ``VOCPointDataset``. Returns the paths the datasets take."""
    import json

    from PIL import Image

    rs = np.random.RandomState(seed)
    for sub in ("JPEGImages", "SegmentationObject", "SegmentationClass", "ImageSets/Segmentation",
                "Annotations_coco"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    images, annotations, ids = [], [], []
    for i, (h, w) in enumerate(sizes):
        name = f"2012_{i:06d}"
        masks, rings = _blobs(rs, h, w, 2 + i % 2)
        img = (rs.rand(h, w, 3) * 60 + 40).astype(np.float32)
        obj = np.zeros((h, w), np.uint8)
        cls = np.zeros((h, w), np.uint8)
        for j, (m, ring) in enumerate(zip(masks, rings)):
            c = 1 + (3 * i + 7 * j) % 20
            img[m] += 120.0 * np.eye(3)[j % 3]
            obj[m], cls[m] = j + 1, c
            obj[ring & (obj == 0)], cls[ring & (cls == 0)] = 255, 255
            ys, xs = np.nonzero(m)
            annotations.append(dict(id=len(annotations), image_id=i, category_id=c,
                                    point=[float(xs.mean()), float(ys.mean())]))
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(root / "JPEGImages" / f"{name}.jpg")
        for sub, a in (("SegmentationObject", obj), ("SegmentationClass", cls)):
            png = Image.fromarray(a, mode="P")
            png.putpalette(_palette())
            png.save(root / sub / f"{name}.png")
        images.append(dict(id=i, file_name=f"{name}.jpg", width=w, height=h))
        ids.append(name)
    from attentionshift_tpu.data.voc import VOC_CLASSES

    cats = [dict(id=k + 1, name=n) for k, n in enumerate(VOC_CLASSES)]
    ann_file = root / "Annotations_coco" / "train.json"
    ann_file.write_text(json.dumps(dict(images=images, annotations=annotations, categories=cats)))
    split = root / "ImageSets" / "Segmentation" / "val.txt"
    split.write_text("\n".join(ids) + "\n")
    return dict(ann_file=str(ann_file), img_prefix=str(root / "JPEGImages"),
                split_file=str(split), voc_root=str(root))


def disc_tree(root, sizes=TREE_SIZES, n_discs: int = 3, seed: int = 0) -> dict:
    """A point-annotation tree under ``root``: PNG images of ``blob_inputs``'
    scenes (bright discs on a quiet background, taken back to pixels with
    the ImageNet statistics), one point per disc at its center, and a
    ``VOCPointDataset`` json. Random TINY weights give these scenes a
    well-conditioned Stage B, where ``voc_tree``'s noisy JPEGs often meet
    its near-ties (ROADMAP section C)."""
    import json

    from PIL import Image

    from attentionshift_tpu.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
    from attentionshift_tpu.data.voc import VOC_CLASSES

    (root / "JPEGImages").mkdir(parents=True, exist_ok=True)
    images, annotations = [], []
    for i, (h, w) in enumerate(sizes):
        img, pts, _, _, _ = blob_inputs(h, w, n_discs, n_discs, seed=seed + i)
        pixels = (img[0] * IMAGENET_STD + IMAGENET_MEAN).clip(0, 255).astype(np.uint8)
        name = f"disc_{i:06d}.png"
        Image.fromarray(pixels).save(root / "JPEGImages" / name)
        images.append(dict(id=i, file_name=name, width=w, height=h))
        for j in range(n_discs):
            annotations.append(dict(id=len(annotations), image_id=i,
                                    category_id=1 + (3 * i + 7 * j) % 20,
                                    point=[float(v) for v in pts[0, j]]))
    cats = [dict(id=k + 1, name=n) for k, n in enumerate(VOC_CLASSES)]
    ann_file = root / "train.json"
    ann_file.write_text(json.dumps(dict(images=images, annotations=annotations, categories=cats)))
    return dict(ann_file=str(ann_file), img_prefix=str(root / "JPEGImages"))


def coco_tree(root, sizes=TREE_SIZES, seed: int = 1) -> dict:
    """A COCO-layout tree under ``root``: images, and one json whose
    instances carry a point and a segmentation in each of COCO's three
    forms (polygon list, RLE string, uncompressed RLE counts), one of them
    a crowd region, over non-contiguous category ids."""
    import json

    from PIL import Image

    from attentionshift_tpu import native as jnative

    rs = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    cat_ids = [3, 8, 11, 17, 40]
    images, annotations = [], []
    for i, (h, w) in enumerate(sizes):
        masks, _ = _blobs(rs, h, w, 3)
        img = (rs.rand(h, w, 3) * 60 + 40).astype(np.float32)
        for j, m in enumerate(masks):
            img[m] += 120.0 * np.eye(3)[j % 3]
            ys, xs = np.nonzero(m)
            ann = dict(id=len(annotations), image_id=10 + i, category_id=cat_ids[(i + 2 * j) % 5],
                       point=[float(xs.mean()), float(ys.mean())], iscrowd=int(j == 2 and i == 1))
            if j == 0:  # polygon: the mask's bounding octagon
                x0, y0, x1, y1 = xs.min(), ys.min(), xs.max(), ys.max()
                dx, dy = (x1 - x0) / 4, (y1 - y0) / 4
                ann["segmentation"] = [[float(v) for v in (
                    x0 + dx, y0, x1 - dx, y0, x1, y0 + dy, x1, y1 - dy, x1 - dx, y1, x0 + dx, y1,
                    x0, y1 - dy, x0, y0 + dy)]]
            elif j == 1:  # compressed RLE string
                rle = jnative.rle_encode(m)
                ann["segmentation"] = dict(size=[h, w],
                                           counts=jnative.rle_to_string(rle).decode())
            else:  # uncompressed RLE counts
                rle = jnative.rle_encode(m)
                ann["segmentation"] = dict(size=[h, w], counts=[int(c) for c in rle["counts"]])
            annotations.append(ann)
        name = f"{i:012d}.jpg"
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(root / "images" / name)
        images.append(dict(id=10 + i, file_name=name, width=w, height=h))
    cats = [dict(id=c, name=f"cat{c}") for c in cat_ids]
    ann_file = root / "instances.json"
    ann_file.write_text(json.dumps(dict(images=images, annotations=annotations, categories=cats)))
    return dict(ann_file=str(ann_file), img_prefix=str(root / "images"))


def sbd_tree(root, seed: int = 2) -> dict:
    """An SBD-layout tree under ``root``: ``img/``, ``cls/`` and ``inst/``
    .mat files of two images and a split file."""
    import scipy.io
    from PIL import Image

    rs = np.random.RandomState(seed)
    for sub in ("img", "cls", "inst"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    names = []
    for i, (h, w) in enumerate(TREE_SIZES):
        masks, _ = _blobs(rs, h, w, 2 + i)
        cls_img = np.zeros((h, w), np.uint8)
        inst_img = np.zeros((h, w), np.uint8)
        for j, m in enumerate(masks):
            cls_img[m], inst_img[m] = 1 + (5 * i + 3 * j) % 20, j + 1
        name = f"sbd_{i}"
        scipy.io.savemat(root / "cls" / f"{name}.mat", {"GTcls": {"Segmentation": cls_img}})
        scipy.io.savemat(root / "inst" / f"{name}.mat", {"GTinst": {"Segmentation": inst_img}})
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "img" / f"{name}.jpg")
        names.append(name)
    split = root / "train.txt"
    split.write_text("\n".join(names) + "\n")
    return dict(split_file=str(split), sbd_root=str(root))
