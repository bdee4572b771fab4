"""Training CLI: the port's twin of ``tools/train.py``.

    python -m attentionshift_torch.tools.train CFG [--work-dir W] [--resume-from P] \\
        [--no-auto-resume] [--no-validate] [--validate-limit N] [--max-steps N] \\
        [--cfg-options a.b=v ...] [--device cpu]
    torchrun --nproc_per_node N -m attentionshift_torch.tools.train CFG ...

Builds the VOC (or COCO) point dataset, its ``TrainPipeline`` and the
``TrainLoader`` over this rank's stride of it, the ``AttnShiftDetector``
of ``CFG``'s ``model`` block (seeded init, then the MAE graft when
``pretrained`` names a checkpoint), the layer-decay AdamW over the port's
parameter names (running statistics are buffers no optimizer touches).
With ``model_type = "mask_rcnn"`` (the refinement stage,
``configs/mrcnn_refine_voc.py``) it builds instead the
``InstanceCocoDataset`` of the pseudo-label json that
``tools.gen_pseudo_labels`` writes, its ``RefineTrainPipeline``, the
ResNet-FPN ``MaskRCNN`` (seeded init, then the torchvision ResNet graft
when ``pretrained`` names a checkpoint), the SGD recipe over its
trainable parameters and ``make_refine_train_step``. Then it
runs the epoch loop: epoch-gated loss weights, a log line and a
``train_log.jsonl`` record every ``log_interval`` steps after the
non-finite check, an epoch checkpoint ``W/epoch_N`` every
``checkpoint_interval`` epochs, auto-resume from the latest one, and the
val metric every ``eval_interval`` epochs.

The model runs on the card unless ``--device cpu`` asks for the plain
PyTorch path (f32): the AttnShift detector in bf16 compute with f32
parameters, the Mask R-CNN in f32, as the JAX package runs it. Under
``torchrun`` each rank is one process on one card: ``data.batch_size`` is
per rank, the train step computes the losses and gradients of the global
batch, and rank 0 alone logs, saves and evaluates. Tensor, sequence and
pipeline parallelism raise ``NotImplementedError``.

With ``teacher.enabled`` (``configs/attnshift_voc12aug_ts.py``) the step
is ``train.make_train_step_ts``: an EMA teacher, a copy of the student
made after the build and any resume (no checkpoint holds it, as in the
JAX package), feeds the pseudo-label engine and follows the student by
``teacher.momentum`` after every micro-step.

A step's draws come from a generator seeded from (seed + 1, step, rank)
(``train.step_generator``), so a run resumed from a checkpoint draws what
an unbroken run draws.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import os
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train an AttnShift detector with the port.")
    p.add_argument("config")
    p.add_argument("--work-dir", default="work_dirs/attnshift")
    p.add_argument("--resume-from", default=None)
    p.add_argument("--no-auto-resume", action="store_true")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--validate-limit", type=int, default=None,
                   help="eval only the first N val images each epoch")
    p.add_argument("--max-steps", type=int, default=None,
                   help="debug: stop after N train steps (micro-steps) of this run")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args) -> SimpleNamespace:
    """Everything the epoch loop needs, from parsed ``args``: the config,
    this rank's place in the process group, dataset, loader, model (MAE or
    ResNet grafted), train state (resumed) and step function."""
    from ..config import Config
    from ..data.build import build_train_dataset
    from ..data.loader import TrainLoader
    from ..data.pipeline import TrainPipeline
    from ..data.refine import RefineTrainPipeline
    from ..device import resolve_device
    from ..parallel.mesh import init_distributed, mesh_from_config, place_state
    from ..train import TrainState, latest_checkpoint, restore_checkpoint

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    rank, world, dev = init_distributed(resolve_device(args.device))
    dp = mesh_from_config(cfg.get("parallel", {}), world)
    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    os.makedirs(args.work_dir, exist_ok=True)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"env: torch {torch.__version__}, device {dev} ({name}), rank {rank}/{world}"
          f"{', backend ' + dist.get_backend() if group is not None else ''}", flush=True)
    if rank == 0:
        with open(os.path.join(args.work_dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f, indent=2, default=str)

    seed = int(cfg.runtime.seed)
    refine = cfg.get("model_type", "attnshift") == "mask_rcnn"
    dataset = build_train_dataset(cfg.data.train.to_dict())
    scales = [tuple(s) for s in cfg.data.train_scales]
    if refine:
        pipeline = RefineTrainPipeline(
            scales=scales, max_gt=int(cfg.data.max_gt), flip_ratio=float(cfg.data.flip_ratio),
            mask_stride=int(cfg.model.get("mask_stride", 4)))
    else:
        crop = cfg.data.get("crop_size", None)
        pipeline = TrainPipeline(
            scales=scales, max_gt=int(cfg.data.max_gt), flip_ratio=float(cfg.data.flip_ratio),
            crop_size=tuple(crop) if crop else None,
            brightness_delta=float(cfg.data.get("brightness_delta", 0.0)))
    loader = TrainLoader(dataset, pipeline, batch_size=int(cfg.data.batch_size), seed=seed,
                         num_threads=int(cfg.data.num_threads), process_index=rank,
                         process_count=dp)
    # every rank runs this many steps per epoch (each is a collective);
    # the schedule counts epochs in them
    steps_per_epoch = loader.steps_per_epoch()
    print(f"dataset: {len(dataset)} samples, {steps_per_epoch} steps/epoch per rank", flush=True)
    # NumClassCheckHook analog: dataset labels must fit the head
    max_label = max((int(s.labels.max()) for s in dataset.samples if len(s.labels)), default=-1)
    if max_label >= int(cfg.model.num_classes):
        raise ValueError(f"dataset contains label {max_label} but model.num_classes="
                         f"{cfg.model.num_classes} (NumClassCheckHook)")

    model, opt, step_fn = (_build_refine if refine else _build_attnshift)(
        cfg, dev, seed, steps_per_epoch, group)
    state = TrainState.create(model, opt)
    resume = args.resume_from
    if resume is None and not args.no_auto_resume:
        resume = latest_checkpoint(args.work_dir)
    if resume:
        state = restore_checkpoint(resume, state)
        print(f"resumed from {resume} (epoch {state.epoch})", flush=True)
    state = place_state(state, group)
    run = SimpleNamespace(cfg=cfg, args=args, rank=rank, world=world, device=dev, group=group,
                          seed=seed, dataset=dataset, loader=loader,
                          steps_per_epoch=steps_per_epoch, model=model, state=state,
                          step_fn=step_fn, resumed=resume, teacher=None)
    if cfg.get("teacher", {}).get("enabled", False):
        _attach_teacher(run, float(cfg.teacher.get("momentum", 0.999)))
    return run


def _attach_teacher(run: SimpleNamespace, momentum: float) -> None:
    """Make ``run.teacher`` a copy of the built (and resumed) student and
    ``run.step_fn`` the teacher-student step, which moves it."""
    from ..train import make_train_step_ts

    run.teacher = copy.deepcopy(run.model)
    step_ts = make_train_step_ts(run.model, momentum, run.group)

    def step_fn(state, batch, **kw):
        state, run.teacher, metrics = step_ts(state, run.teacher, batch, **kw)
        return state, metrics

    run.step_fn = step_fn


def _schedule_kw(cfg, steps_per_epoch: int) -> dict:
    """The optimizer arguments both recipes take from the config."""
    return dict(base_lr=float(cfg.optimizer.base_lr),
                weight_decay=float(cfg.optimizer.weight_decay),
                steps_per_epoch=steps_per_epoch, decay_epochs=tuple(cfg.schedule.decay_epochs),
                warmup_iters=int(cfg.schedule.warmup_iters),
                warmup_ratio=float(cfg.schedule.warmup_ratio),
                accumulate_steps=int(cfg.optimizer.accumulate_steps),
                grad_clip=cfg.optimizer.get("grad_clip"),
                skip_nonfinite=cfg.optimizer.get("skip_nonfinite", 100))


def _build_attnshift(cfg, dev, seed: int, steps_per_epoch: int, group):
    """(model, optimizer, step function) of the AttnShift detector."""
    from ..models import AttnShiftDetector
    from ..models.convert import load_torch_state_dict, mae_to_vit_params
    from ..train import build_optimizer, make_train_step

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = AttnShiftDetector(device=dev, dtype=dtype, **cfg.model.to_dict()).init_weights(seed)
    if cfg.get("pretrained"):
        sd = load_torch_state_dict(cfg.pretrained)
        model.backbone.load_state_dict(
            mae_to_vit_params(sd, model.backbone.state_dict(), depth=int(cfg.model.depth)))
        print(f"loaded MAE pretrain: {cfg.pretrained}", flush=True)
    # layer decay over the port's parameter names; the JAX CLI hands its
    # optimizer the whole variables dict, which makes every scale 1.0
    # (ROADMAP section C)
    opt = build_optimizer(model, layer_decay=float(cfg.optimizer.layer_decay),
                          depth=int(cfg.model.depth), **_schedule_kw(cfg, steps_per_epoch))
    return model, opt, make_train_step(model, group)


def _build_refine(cfg, dev, seed: int, steps_per_epoch: int, group):
    """(model, optimizer, step function) of the refinement stage's Mask
    R-CNN (f32, as the JAX package runs it)."""
    from ..models.convert import load_torch_state_dict, torchvision_resnet_params
    from ..models.mask_rcnn import MaskRCNN
    from ..train import build_sgd_optimizer, make_refine_train_step

    model = MaskRCNN(device=dev, **cfg.model.to_dict()).init_weights(seed)
    if cfg.get("pretrained"):
        sd = load_torch_state_dict(cfg.pretrained)
        model.backbone.load_state_dict(torchvision_resnet_params(sd, model.backbone.state_dict()))
        print(f"loaded ResNet pretrain: {cfg.pretrained}", flush=True)
    opt = build_sgd_optimizer(model, momentum=float(cfg.optimizer.get("momentum", 0.9)),
                              frozen_stages=int(cfg.model.get("frozen_stages", 1)),
                              **_schedule_kw(cfg, steps_per_epoch))
    return model, opt, make_refine_train_step(model, group)


def train_step(run: SimpleNamespace, batch: dict, epoch: int, draws=None) -> dict:
    """One train step of ``run`` on a numpy ``batch`` of this rank, with the
    step's generator and the epoch's loss gate; returns the metrics
    (tensors on the device, global under a process group)."""
    from ..parallel.mesh import shard_batch
    from ..train import step_generator

    enable = 1.0 if epoch >= int(run.cfg.runtime.loss_weight_start_epoch) else 0.0
    gen = step_generator(run.seed, run.state.step, run.device, run.rank)
    run.state, metrics = run.step_fn(run.state, shard_batch(batch, run.device), generator=gen,
                                     loss_enable=enable, draws=draws)
    return metrics


def fit(run: SimpleNamespace) -> dict:
    """The epoch loop of ``run``; returns what it measured: host-clock ms
    of each step and of each wait on the loader, seconds of each
    checkpoint save and evaluation, the val metrics and the last logged
    metrics."""
    from ..data.build import build_eval_dataset
    from ..eval.runner import evaluate
    from ..train import save_checkpoint
    from ..utils import MetricLogger, check_finite_losses

    cfg, args = run.cfg, run.args
    rt = cfg.runtime
    mlog = MetricLogger(os.path.join(args.work_dir, "train_log.jsonl")) if run.rank == 0 else None
    stats = dict(step_ms=[], wait_ms=[], save_s=[], eval_s=[], val=[], metrics=None,
                 resumed=run.resumed, start_epoch=run.state.epoch)
    done_steps = 0
    for epoch in range(run.state.epoch, int(cfg.schedule.total_epochs)):
        t_ep = time.time()
        batches = run.loader.epoch(epoch)
        for i in itertools.count():
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            metrics = train_step(run, batch, epoch)
            done_steps += 1
            if i % int(rt.log_interval) == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                check_finite_losses(metrics, step=done_steps)
                stats["metrics"] = metrics
                if mlog is not None:
                    mlog.update(metrics)
                    print(mlog.line(epoch, i, run.steps_per_epoch), flush=True)
            stats["wait_ms"].append((t1 - t0) * 1e3)
            stats["step_ms"].append((time.perf_counter() - t1) * 1e3)
            if args.max_steps and done_steps >= args.max_steps:
                break
        batches.close()
        run.state.next_epoch()
        if run.rank == 0 and (epoch + 1) % int(rt.checkpoint_interval) == 0:
            t0 = time.perf_counter()
            path = save_checkpoint(args.work_dir, run.state)
            stats["save_s"].append(time.perf_counter() - t0)
            print(f"saved {path} ({time.time() - t_ep:.1f}s/epoch)", flush=True)
        # EvalHook analog: the val metric every eval_interval epochs
        if (not args.no_validate and run.rank == 0 and cfg.data.get("val")
                and (epoch + 1) % int(rt.get("eval_interval", 1)) == 0):
            t0 = time.perf_counter()
            metrics_val = evaluate(run.model, build_eval_dataset(cfg.data.val.to_dict()),
                                   test_scale=tuple(cfg.data.test_scale),
                                   limit=args.validate_limit,
                                   num_classes=int(cfg.model.num_classes), verbose=False)
            stats["eval_s"].append(time.perf_counter() - t0)
            stats["val"].append(metrics_val)
            print(f"epoch {epoch} val: { {k: round(v, 4) for k, v in metrics_val.items()} }",
                  flush=True)
        if args.max_steps and done_steps >= args.max_steps:
            break
    print("training done", flush=True)
    return stats


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns ``fit``'s measurements. A process
    group that this call created is destroyed before it returns."""
    args = parse_args(argv)
    had_group = dist.is_available() and dist.is_initialized()
    try:
        return fit(build(args))
    finally:
        if not had_group and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
