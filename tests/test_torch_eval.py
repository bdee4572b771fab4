"""The port's evaluation path against the JAX package's.

``coco_segm_eval`` (the COCO fuzz cases), the checkpoint format (a
save/restore round trip inside a train step's accumulation window;
``ckpt3k`` converted and exported), ``AugTester`` (multi-scale + flip
testing) and ``evaluate``'s filesystem gather, each on the same inputs
and weights through both packages on the CPU in f32. ``evaluate`` end to
end and the CLI are in ``test_torch_cli.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_support import (AUG_SCALES, BOX_TOL, PROB_TOL, TINY, blob_inputs,  # noqa: E402
                                ckpt3k_variables, close, drop_weights, eval_models, torch_model)

# ------------------------------------------------------------------ COCO AP


def test_coco_segm_eval_matches_jax_package():
    """The 300 COCO fuzz cases of ``tests/test_data_eval.py``
    (``test_coco_fuzz``: crowd regions, score ties, maxDets truncation,
    empty classes) through both packages: AP, AP50, AP75 and the per-class
    table within 1e-12 (the same float64 arithmetic)."""
    import test_data_eval

    from attentionshift_torch.eval import coco_segm_eval
    from attentionshift_tpu.eval.coco_eval import coco_segm_eval as jeval

    make = test_data_eval.TestCocoEvalOracleFuzz()._case
    rng = np.random.RandomState(7)
    for case in range(300):
        pm, pl, ps, gm, gl, gc = make(rng)
        kw = dict(num_classes=5, gt_iscrowd=gc, max_dets=[2, 3, 100][case % 3])
        got, want = coco_segm_eval(pm, pl, ps, gm, gl, **kw), jeval(pm, pl, ps, gm, gl, **kw)
        assert sorted(got) == sorted(want)
        for k in ("AP", "AP50", "AP75"):
            assert abs(got[k] - want[k]) <= 1e-12, (case, k, got[k], want[k])
        np.testing.assert_allclose(got["per_class"], want["per_class"], atol=1e-12, rtol=0,
                                   equal_nan=True, err_msg=f"case {case}")


# --------------------------------------------------------------- checkpoints

TRAIN_KW = dict(TINY, max_gt=4, num_proposals=100, rpn_nms_pre=200, rcnn_samples=64,
                mask_sample_cap=16)


def _train_state(seed: int):
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.train import TrainState, build_optimizer

    model = AttnShiftDetector(device="cpu", use_remat=False, **TRAIN_KW).init_weights(seed)
    opt = build_optimizer(model, base_lr=1e-3, steps_per_epoch=100, warmup_iters=2,
                          accumulate_steps=2, depth=TRAIN_KW["depth"])
    return TrainState.create(model, opt)


def _state_tensors(state) -> dict:
    opt = state.optimizer.state_dict()
    out = {f"params.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for key in ("mu", "nu", "acc"):
        out.update({f"{key}.{k}": v for k, v in opt[key].items()})
    return out


def test_checkpoint_round_trip_resumes_bitwise(tmp_path):
    """``save_checkpoint`` in the middle of an accumulation window, then
    ``restore_checkpoint`` into a differently initialised state: the next
    two train steps give, bitwise, what they give without the round trip
    (parameters, buffers, Adam moments, accumulator, counters, step and
    epoch). ``latest_checkpoint`` picks the highest epoch; ``restore_params``
    reads the parameters and buffers without an optimizer."""
    from attentionshift_torch.train import (latest_checkpoint, make_train_step, restore_checkpoint,
                                            restore_params, save_checkpoint)

    img, pts, lbl, valid, wh = map(torch.from_numpy, blob_inputs(64, 96, 4, 3, seed=0))
    batch = dict(img=img, gt_points=pts, gt_labels=lbl, gt_valid=valid, img_wh=wh)

    def step(state, seed):
        return make_train_step(state.model)(state, batch,
                                            generator=torch.Generator().manual_seed(seed))[0]

    state = step(step(_train_state(0), 1), 2)  # one full update made
    state = step(state, 3)  # the accumulator now holds one gradient
    assert state.optimizer.count == 1 and state.optimizer.mini_step == 1
    state.next_epoch()
    path = save_checkpoint(str(tmp_path), state, extra=dict(cursor=7))
    state.epoch = 2
    save_checkpoint(str(tmp_path), state)
    state.epoch = 1
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_2")
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert path == str(tmp_path / "epoch_1")

    restored = restore_checkpoint(path, _train_state(7))
    assert (restored.step, restored.epoch) == (3, 1)
    before = _state_tensors(state)
    for name, t in _state_tensors(restored).items():
        assert torch.equal(t, before[name]), name
    want = step(step(state, 4), 5)
    got = step(step(restored, 4), 5)
    assert got.optimizer.count == want.optimizer.count == 2
    for k in ("mini_step", "notfinite_count", "last_finite", "total_notfinite"):
        assert getattr(got.optimizer, k) == getattr(want.optimizer, k), k
    assert got.step == want.step == 5
    after = _state_tensors(want)
    for name, t in _state_tensors(got).items():
        assert torch.equal(t, after[name]), name
    assert not torch.equal(after["params.mil_head.fc1.weight"],
                           before["params.mil_head.fc1.weight"])

    params = restore_params(path)
    assert set(params) == set(state.model.state_dict())
    assert all(torch.equal(params[k], before[f"params.{k}"]) for k in params)
    assert torch.load(path, weights_only=True)["extra"] == dict(cursor=7)
    drop_weights(tmp_path)


def test_checkpoint_rejects_another_optimizer_layout(tmp_path):
    """A checkpoint taken with gradient accumulation does not load into an
    optimizer without it."""
    from attentionshift_torch.train import build_optimizer, restore_checkpoint, save_checkpoint

    state = _train_state(0)
    path = save_checkpoint(str(tmp_path), state)
    state.optimizer = build_optimizer(state.model, accumulate_steps=1, depth=TRAIN_KW["depth"])
    with pytest.raises(ValueError, match="accumulation"):
        restore_checkpoint(path, state)
    drop_weights(tmp_path)


def test_ckpt3k_converts_exports_and_restores(tmp_path):
    """The orbax fixture ``ckpt3k`` restored by the JAX package, converted
    with ``load_flax``, exported with ``save_params`` and restored by the
    port into a fresh model: every tensor equal to the converted one."""
    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.train import restore_params, save_params

    from test_torch_support import VITS

    converted = torch_model(ckpt3k_variables(), **VITS)
    want = converted.state_dict()
    path = save_params(str(tmp_path / "ckpt3k.pt"), want)
    fresh = AttnShiftDetector(device="cpu", **VITS)
    fresh.load_state_dict(restore_params(path), strict=True)
    got = fresh.state_dict()
    assert set(got) == set(want) == set(flax_to_torch(ckpt3k_variables()))
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    drop_weights(tmp_path)


# ------------------------------------------------------------------ AugTester

@pytest.fixture(scope="module")
def models():
    return eval_models()


def _check_dets(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["boxes", "labels", "mask_probs", "scores", "valid"]
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    close(got["boxes"], want["boxes"], what="boxes", **BOX_TOL)
    close(got["scores"], want["scores"], PROB_TOL, what="scores")
    v = want["valid"]
    close(got["mask_probs"][v], want["mask_probs"][v], PROB_TOL, what="mask probs")


@pytest.mark.parametrize("hw", [(120, 160), (160, 120)], ids=["landscape", "portrait"])
def test_aug_tester_matches_jax(models, hw):
    """Two scales with flip, ``max_dets`` 8, on a landscape and a portrait
    image: validity and labels exactly, boxes ``BOX_TOL``, scores and mask
    probabilities ``PROB_TOL``; detections really there and inside the
    original frame."""
    from attentionshift_torch.eval import AugTester

    h, w = hw
    rs = np.random.RandomState(h)
    img = (rs.rand(h, w, 3) * 80 + 60).astype(np.uint8)
    img[h // 4: h // 2, w // 5: w // 2] = (220, 40, 40)
    want = models["jaug"](img, max_dets=8)
    got = AugTester(models["port"], scales=AUG_SCALES, flip=True)(img, max_dets=8)
    _check_dets(got, dict(want))
    assert got["valid"].sum() >= 3
    b = got["boxes"][got["valid"]]
    assert (b >= 0).all() and (b[:, 0::2] <= w).all() and (b[:, 1::2] <= h).all()


# ------------------------------------------------------------------ evaluate


def test_evaluate_multiprocess_gather_matches_single(tmp_path):
    """Sharded eval through the filesystem gather, as the JAX package's
    test runs it: two simulated processes give the single-process metrics
    exactly, and process 1 returns None."""
    from attentionshift_torch.core.postprocess import Detections
    from attentionshift_torch.eval import evaluate
    from attentionshift_torch.models import TestOutputs

    k = 4

    class StubModel:
        """Deterministic detector: one fixed box+mask per image."""

        device = torch.device("cpu")

        def simple_test(self, img, wh):
            boxes = torch.tensor([[8.0, 8.0, 40.0, 48.0]]).repeat(k, 1)[None]
            scores = torch.tensor([[0.9, 0.0, 0.0, 0.0]])
            labels = torch.zeros((1, k), dtype=torch.int32)
            valid = torch.tensor([[True, False, False, False]])
            return TestOutputs(Detections(boxes, scores, labels, valid), torch.ones((1, k, 28, 28)))

    class StubDataset:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            return dict(img=(rng.rand(64, 96, 3) * 255).astype(np.uint8))

        def gt_instances(self, i):
            m = np.zeros((1, 64, 96), np.uint8)
            m[0, 8:48, 8:40] = 1
            return dict(masks=m, labels=np.zeros(1, np.int64))

    ds = StubDataset()
    kw = dict(test_scale=(64, 96), num_classes=3, verbose=False)
    single = evaluate(StubModel(), ds, **kw)
    r1 = evaluate(StubModel(), ds, process_index=1, process_count=2, gather_dir=str(tmp_path), **kw)
    assert r1 is None
    r0 = evaluate(StubModel(), ds, process_index=0, process_count=2, gather_dir=str(tmp_path), **kw)
    assert r0 == single
    assert r0["mAP@0.25"] > 0.9  # the stub box matches the gt mask
    with pytest.raises(ValueError, match="gather_dir"):
        evaluate(StubModel(), ds, process_count=2, **kw)
