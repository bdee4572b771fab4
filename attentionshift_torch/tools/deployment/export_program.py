"""Export the inference graph as a ``torch.export`` program for serving.

The port's twin of ``tools/deployment/export_stablehlo.py``, which
serializes StableHLO through ``jax.export``. Here the portable artifact
is a ``torch.export`` ``ExportedProgram`` written with
``torch.export.save`` (a ``.pt2`` archive), loadable with
``torch.export.load`` by any process that has imported
``attentionshift_torch.ops.attention`` (the attention custom ops, whose
CUDA implementations launch the hand-written kernels).

Exports ``AttnShiftDetector.simple_test`` (or the Mask R-CNN refinement
model's, for ``model_type = "mask_rcnn"``) at a fixed serving resolution,
with the checkpoint's weights baked into the program
(``--weights-as-args`` makes the parameters and buffers program inputs
instead, for weight-swappable deployments, through
``torch.func.functional_call``).

    python -m attentionshift_torch.tools.deployment.export_program \\
        configs/attnshift_voc12aug.py work_dirs/voc/epoch_12 --out detector.pt2 \\
        [--scale 800 1344] [--weights-as-args] [--cfg-options ...] [--skip-check] [--device cpu]

Without a checkpoint the weights are ``init_weights(0)``'s, as the JAX
tool exports ``model.init``'s. The checkpoint is one of the port's
(``train.save_checkpoint`` or ``train.save_params``). The detector runs
in bf16 on the card and in f32 on the CPU (``--device cpu``); the Mask
R-CNN in f32. Round-trip check: the tool reloads the saved artifact and
compares every output against the live model on a seeded random image
at rtol = atol = 1e-5 before it reports.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.utils._pytree as pytree


def register_outputs() -> None:
    """Register the output NamedTuples with torch's pytree under
    serialized names, so the saved program keeps their structure (the JAX
    tool's ``register_namedtuple_serialization``)."""
    from ...core.postprocess import Detections
    from ...models.detector import TestOutputs
    from ...models.mask_rcnn import MaskRCNNTestOutputs

    for nt in (Detections, TestOutputs, MaskRCNNTestOutputs):
        name = f"attentionshift_torch.{nt.__name__}"
        if nt not in pytree.SUPPORTED_SERIALIZED_TYPES:
            pytree._register_namedtuple(nt, serialized_type_name=name)


class _SimpleTest(torch.nn.Module):
    """``model.simple_test`` as a module's forward (what ``functional_call``
    and ``torch.export`` call)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img, img_wh):
        return self.model.simple_test(img, img_wh)


class Serve(torch.nn.Module):
    """The exported module: ``simple_test`` with the weights baked in, or,
    with ``weights_as_args``, with the model's state dict (keys
    ``model.<name>``) as the first input; the model is then no submodule,
    so the program holds none of its tensors."""

    def __init__(self, model: torch.nn.Module, weights_as_args: bool = False):
        super().__init__()
        self.weights_as_args = weights_as_args
        if weights_as_args:
            object.__setattr__(self, "inner", _SimpleTest(model))
        else:
            self.inner = _SimpleTest(model)

    def forward(self, *args):
        if not self.weights_as_args:
            return self.inner(*args)
        state, img, img_wh = args
        return torch.func.functional_call(self.inner, state, (img, img_wh), strict=True,
                                          tie_weights=False)


def build(args):
    """(model, (H, W) serving resolution) of parsed ``args``."""
    from ...config import Config
    from ...data.pipeline import TestPipeline
    from ...device import resolve_device
    from ...models import AttnShiftDetector
    from ...models.mask_rcnn import MaskRCNN
    from ...train.checkpoint import restore_params

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    dev = resolve_device(args.device)
    if cfg.get("model_type", "attnshift") == "mask_rcnn":
        model = MaskRCNN(device=dev, **cfg.model.to_dict())
    else:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        model = AttnShiftDetector(device=dev, dtype=dtype, **cfg.model.to_dict())
    model.init_weights(0)
    if args.checkpoint:
        model.load_state_dict(restore_params(args.checkpoint), strict=True)
        print(f"loaded {args.checkpoint}")
    model.eval()
    scale = tuple(cfg.data.test_scale)
    hw = tuple(args.scale) if args.scale else TestPipeline(scale=scale).bucket_hw
    return model, hw


def export(model, hw, weights_as_args: bool = False):
    """(ExportedProgram, example inputs, live function) of ``model``'s
    ``simple_test`` at the serving resolution ``hw``."""
    bh, bw = hw
    dev = model.device
    img0 = torch.zeros((1, bh, bw, 3), device=dev)
    wh0 = torch.tensor([[float(bw), float(bh)]], device=dev)
    serve = Serve(model, weights_as_args)
    state = {f"model.{k}": v for k, v in model.state_dict().items()}
    ex_args = (state, img0, wh0) if weights_as_args else (img0, wh0)
    with torch.no_grad():
        # one eager call first fills the heads' position-table caches with
        # real tensors, which the program then holds as constants
        serve(*ex_args)
        program = torch.export.export(serve, ex_args)
    if weights_as_args:
        program.example_inputs = None  # they hold the weights, which the artifact must not
    return program, ex_args, serve


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Export simple_test as a torch.export program.")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--scale", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="serving resolution (default: the config's test bucket)")
    ap.add_argument("--weights-as-args", action="store_true",
                    help="export weights as runtime arguments instead of baked-in constants")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--skip-check", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def round_trip(path: str, serve, ex_args, hw) -> None:
    """Reload ``path`` and compare every output of the reloaded program
    with the live model's on a seeded random image (rtol = atol = 1e-5)."""
    bh, bw = hw
    dev = ex_args[-1].device
    x = torch.from_numpy(np.random.RandomState(0).randn(1, bh, bw, 3).astype(np.float32)).to(dev)
    args = (*ex_args[:-2], x, ex_args[-1])
    reloaded = torch.export.load(path).module()
    with torch.no_grad():
        want = pytree.tree_leaves(serve(*args))
        got = pytree.tree_leaves(reloaded(*args))
    if len(got) != len(want):
        raise AssertionError(f"the reloaded program gives {len(got)} outputs, the model "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"output {i}")


def main(argv=None) -> dict:
    """Export, save and (unless ``--skip-check``) round-trip; returns what
    it wrote, the program, the live module and the example inputs."""
    from ...ops import attention  # noqa: F401  (the custom ops a reload needs)

    args = parse_args(argv)
    register_outputs()
    model, hw = build(args)
    print(f"serving resolution: {hw[0]}x{hw[1]}")
    program, ex_args, serve = export(model, hw, args.weights_as_args)
    torch.export.save(program, args.out)
    if not args.skip_check:
        round_trip(args.out, serve, ex_args, hw)
        print("round-trip check OK")
    size = os.path.getsize(args.out)
    print(f"wrote {args.out} ({size / 1e6:.1f} MB, torch {torch.__version__})")
    return dict(out=args.out, bytes=size, hw=hw, program=program, live=serve, args=ex_args)


if __name__ == "__main__":
    main()
