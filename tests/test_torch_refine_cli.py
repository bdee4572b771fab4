"""The refinement stage through the port's entry points, on the CPU.

The recipe of ``configs/mrcnn_refine_voc.py`` at a TINY width, each step
through the port's CLI in this process:

1. ``tools.gen_pseudo_labels`` dumps pseudo boxes and masks (RLE) of a
   TINY AttnShift detector over a tree of disc images;
2. ``tools.train`` on a ``model_type = "mask_rcnn"`` config reads that json
   (``InstanceCocoDataset``, ``RefineTrainPipeline``) and trains the TINY
   Mask R-CNN (ResNet depths (1, 1, 1, 1), frozen stem and ``layer1``) for
   two steps with the SGD recipe;
3. ``tools.test`` evaluates the checkpoint single-scale and with
   ``--aug-test`` (two scales x flip, cut for the CPU).

Also: a run resumed from ``epoch_1`` ends bitwise equal to an unbroken run
(parameters, buffers, the momentum trace, counters), and two gloo ranks
(this file run as a script) train the refine config with one image each
and end with equal parameters, the RCNN and mask normalisers all-reduced.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the dump's TINY AttnShift detector (tests/test_torch_support.py TINY)
SEED_MODEL = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, point_tokens=16,
                  cam_layer=3, out_indices=(0, 1, 2, 3), max_gt=4, pad_tokens_to=128,
                  use_remat=False)
REFINE_MODEL = dict(num_classes=20, rpn_channels=32, num_proposals=16, rpn_nms_pre=32,
                    rcnn_samples=8, mask_sample_cap=4, mask_stride=4, depths=(1, 1, 1, 1),
                    frozen_stages=1, test_max_per_img=10, test_score_thr=0.02)
SCALE = (96, 128)
AUG_SCALES = [(96, 128), (64, 96)]


def refine_config(path, pseudo: str, img_prefix: str, val: dict, batch_size: int = 1,
                  total_epochs: int = 1) -> str:
    """A TINY ``model_type = "mask_rcnn"`` config: the pseudo-label json as
    the train set, ``val`` as the VOC val split, SGD with a 2-step warmup."""
    path.write_text(f"""
model_type = "mask_rcnn"
pretrained = ""
model = dict(**{REFINE_MODEL!r})
data = dict(
    train=dict(type="InstanceCocoDataset", ann_file={pseudo!r}, img_prefix={img_prefix!r},
               repeat=1),
    val=dict(split_file={val['split_file']!r}, voc_root={val['voc_root']!r}),
    batch_size={batch_size}, num_threads=1, max_gt=4, flip_ratio=0.5,
    train_scales=[{SCALE!r}], test_scale={SCALE!r})
optimizer = dict(base_lr=0.01, momentum=0.9, weight_decay=1e-4, accumulate_steps=1,
                 grad_clip=None)
schedule = dict(total_epochs={total_epochs}, decay_epochs=[8, 11], warmup_iters=2,
                warmup_ratio=1e-3)
runtime = dict(log_interval=1, checkpoint_interval=1, eval_interval=1, seed=0,
               loss_weight_start_epoch=-1)
""")
    return str(path)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The recipe's chain: the dump of a TINY AttnShift detector's seeded
    init over two disc images, then the refine config over it; the val
    split of ``voc_tree``."""
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.tools import gen_pseudo_labels as gpl
    from attentionshift_torch.train import save_params
    from test_torch_support import disc_tree, voc_tree

    d = tmp_path_factory.mktemp("refine_chain")
    tree = disc_tree(d / "discs", sizes=((96, 128), (96, 128)), seed=1)
    val = voc_tree(d / "VOC2012")
    seed_cfg = d / "seed.py"
    seed_cfg.write_text(f"model = dict(**{SEED_MODEL!r})\n"
                        f"data = dict(train=dict(ann_file={tree['ann_file']!r}, "
                        f"img_prefix={tree['img_prefix']!r}), max_gt=4)\n")
    ckpt = save_params(str(d / "seed_epoch_1"),
                       AttnShiftDetector(device="cpu", **SEED_MODEL).init_weights(0).state_dict())
    pseudo = d / "pseudo_train.json"
    dump = gpl.main([str(seed_cfg), ckpt, "--out", str(pseudo), "--scale", "96", "128",
                     "--device", "cpu"])
    cfg = refine_config(d / "refine.py", str(pseudo), tree["img_prefix"], val)
    return dict(dir=d, tree=tree, val=val, pseudo=str(pseudo), dump=dump, cfg=cfg)


def test_dump_train_test_chain(chain, tmp_path, monkeypatch, capsys):
    """The dump holds RLE masks for every disc; ``tools.train`` reads it and
    takes two SGD steps with finite losses, moving every trainable tensor
    and leaving the frozen stem, ``layer1`` and every FrozenBN buffer
    bitwise as initialised; ``tools.test`` on its ``epoch_1`` prints the VOC
    metric dict, single-scale and ``--aug-test``."""
    from attentionshift_torch.tools import test as test_cli
    from attentionshift_torch.tools import train as cli

    dump = chain["dump"]
    assert len(dump["images"]) == 2 and len(dump["annotations"]) == 6
    assert all(isinstance(a["segmentation"]["counts"], str) for a in dump["annotations"])

    runs = []
    fit = cli.fit
    monkeypatch.setattr(cli, "fit", lambda run: (runs.append(
        (run, {k: v.clone() for k, v in run.model.state_dict().items()})), fit(run))[1])
    work = tmp_path / "work"
    stats = cli.main([chain["cfg"], "--work-dir", str(work), "--max-steps", "2", "--no-validate",
                      "--device", "cpu"])
    run, init = runs[0]
    assert type(run.model).__name__ == "MaskRCNN" and run.state.optimizer.rule == "sgd"
    assert run.model.dtype == torch.float32 and run.model.device.type == "cpu"
    assert len(stats["step_ms"]) == 2 and run.state.step == 2 and run.state.optimizer.count == 2
    log = [json.loads(line) for line in (work / "train_log.jsonl").read_text().splitlines()]
    assert len(log) == 2
    for rec in log:
        assert {"loss_rpn_cls", "loss_cls", "loss_bbox", "loss_mask", "loss_total"} <= set(rec)
        assert all(math.isfinite(v) for k, v in rec.items() if k.startswith("loss"))
    trainable = {n for n, p in run.model.named_parameters() if p.requires_grad}
    after = run.model.state_dict()
    for name, t in after.items():
        if name in trainable:
            assert not torch.equal(t, init[name]), name
        else:
            assert torch.equal(t, init[name]), name
    assert "backbone.conv1.weight" not in trainable and "backbone.layer2.0.conv1.weight" in trainable
    ck = torch.load(work / "epoch_1", weights_only=True)
    assert ck["opt_state"]["rule"] == "sgd" and ck["opt_state"]["count"] == 2

    monkeypatch.setattr(test_cli, "AUG_SCALES", AUG_SCALES)
    capsys.readouterr()
    for extra in ([], ["--aug-test"]):
        got = test_cli.main([chain["cfg"], str(work / "epoch_1"), "--device", "cpu", *extra])
        assert sorted(got) == ["mAP@0.25", "mAP@0.5", "mAP@0.75"], extra
        assert all(math.isfinite(v) for v in got.values())
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got


def test_refine_resume_equals_unbroken_run(chain, tmp_path):
    """Two epochs of one image per step: a first call stopped after epoch 0
    writes ``epoch_1``; a second call resumes from it; its ``epoch_2``
    equals an unbroken two-epoch run's bitwise (parameters and buffers, the
    momentum trace, the step, epoch and optimizer counters)."""
    from attentionshift_torch.tools import train as cli

    cfg = refine_config(tmp_path / "refine2.py", chain["pseudo"], chain["tree"]["img_prefix"],
                        chain["val"], total_epochs=2)
    broken, unbroken = tmp_path / "broken", tmp_path / "unbroken"
    common = ["--no-validate", "--device", "cpu"]
    cli.main([cfg, "--work-dir", str(broken), "--max-steps", "2", *common])
    assert (broken / "epoch_1").exists() and not (broken / "epoch_2").exists()
    second = cli.main([cfg, "--work-dir", str(broken), *common])
    assert second["resumed"] and second["start_epoch"] == 1 and len(second["step_ms"]) == 2
    cli.main([cfg, "--work-dir", str(unbroken), *common])
    a = torch.load(broken / "epoch_2", weights_only=True)
    b = torch.load(unbroken / "epoch_2", weights_only=True)
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (4, 2)
    assert set(a["params"]) == set(b["params"])
    for k in b["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert a["opt_state"]["nu"] is None and a["opt_state"]["count"] == 4
    for k in b["opt_state"]["mu"]:
        assert torch.equal(a["opt_state"]["mu"][k], b["opt_state"]["mu"][k]), k
    assert {k: v for k, v in a["opt_state"].items() if k != "mu"} == \
        {k: v for k, v in b["opt_state"].items() if k != "mu"}


# ------------------------------------------------------------- two ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker(rank: int, out: str, cfg: str) -> None:
    """One rank of ``tools.train.main`` on the refine config (batch 1 per
    rank, one step in each of two epochs); its parameters before and after,
    metrics and all-reduce counts to ``out/rank{rank}.pt``."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from attentionshift_torch.parallel.mesh import COUNTS
    from attentionshift_torch.tools import train as cli

    runs, fit = [], cli.fit
    cli.fit = lambda run: (runs.append((run, {n: p.detach().clone() for n, p in
                                              run.model.named_parameters()})), fit(run))[1]
    stats = cli.main([cfg, "--work-dir", os.path.join(out, f"work{rank}"), "--no-validate",
                      "--device", "cpu", "--cfg-options", "schedule.total_epochs=2"])
    run, init = runs[0]
    torch.save(dict(init=init, metrics=stats["metrics"], steps=len(stats["step_ms"]),
                    counts=dict(COUNTS), world=int(os.environ["WORLD_SIZE"]),
                    params={n: p.detach().clone() for n, p in run.model.named_parameters()}),
               os.path.join(out, f"rank{rank}.pt"))
    print(f"WORKER {rank} OK", flush=True)


def test_two_rank_refine_step_keeps_replicas_equal(chain, tmp_path):
    """Two gloo ranks (``init_distributed`` from RANK / WORLD_SIZE /
    MASTER_ADDR / MASTER_PORT, as ``torchrun`` sets them) train the refine
    config with one image each for two epochs of one step: both ranks run the same
    steps, log the same (global) metrics and end with equal parameters,
    moved from the broadcast init; every step all-reduces the three RCNN
    and mask normalisers, the gradients and the metrics once."""
    cfg = chain["cfg"]
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(tmp_path), cfg], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for rank, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0 and f"WORKER {rank} OK" in log, log[-4000:]
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    assert r0["world"] == r1["world"] == 2 and r0["steps"] == r1["steps"] == 2
    assert r0["metrics"] == r1["metrics"]
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
        assert torch.equal(r0["init"][name], r1["init"][name]), name
    assert sum(not torch.equal(p, r0["init"][n]) for n, p in r0["params"].items()) > 0
    assert r0["counts"] == r1["counts"] == {"normalisers": 6, "gradients": 2, "metrics": 2}


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
