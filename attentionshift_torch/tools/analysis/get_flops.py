"""FLOPs/params report: the port's twin of ``tools/analysis/get_flops.py``.

The JAX tool reads XLA's cost analysis of the compiled inference step;
here ``torch.utils.flop_counter.FlopCounterMode`` counts one eager
``simple_test`` (of ``MaskRCNN`` for ``model_type = "mask_rcnn"``). The
attention custom ops count 4 B H T^2 d each (``ops/attention.py::
attention_flops``, the count of ``chip_smoke.py``'s bound of kernel #2);
their share of the total is reported beside it. Parameters are those of
the modules that ``simple_test`` runs, as the JAX tool counts those that
its ``simple_test`` init creates.

    python -m attentionshift_torch.tools.analysis.get_flops CONFIG \\
        [--shape 512 512] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from ...ops import attention  # noqa: F401  (registers the ops' flop formula)

ATTENTION_OPS = (torch.ops.attentionshift.attention_plain,
                 torch.ops.attentionshift.attention_capture)


def _count_inside_while_loops() -> None:
    """``FlopCounterMode`` has no rule for a ``while_loop`` (the NMS
    fixpoint) and refuses it: run such a loop iteration by iteration with
    the counter active. Registered once per process."""
    from torch._higher_order_ops.while_loop import while_loop_dense, while_loop_op
    from torch.utils.flop_counter import _FlopCounterMode

    if _FlopCounterMode in while_loop_op.python_key_table:
        return

    @while_loop_op.py_impl(_FlopCounterMode)
    def _counted(mode, *args, **kwargs):
        with mode:
            return while_loop_dense(*args, **kwargs)


def count(model, img, img_wh) -> dict:
    """FLOPs of one ``simple_test`` (total, by operator, the attention
    ops') and the parameters it reads: those held by the modules whose
    forward ran."""
    _count_inside_while_loops()
    ran = set()
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, args: ran.add(id(m)))
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model.simple_test(img, img_wh)
    finally:
        hook.remove()
    by_op = fc.get_flop_counts()["Global"]
    params = sum(p.numel() for m in model.modules() if id(m) in ran
                 for p in m.parameters(recurse=False))
    return dict(flops=fc.get_total_flops(),
                attention_flops=sum(by_op.get(op, 0) for op in ATTENTION_OPS),
                params=params, by_op={str(k): v for k, v in by_op.items()})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Parameters and GFLOPs of simple_test.")
    p.add_argument("config")
    p.add_argument("--shape", type=int, nargs=2, default=[512, 512])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from ...config import Config
    from ...device import resolve_device

    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    dev = resolve_device(args.device)
    if cfg.get("model_type", "attnshift") == "mask_rcnn":
        from ...models.mask_rcnn import MaskRCNN

        model = MaskRCNN(device=dev, **cfg.model.to_dict())
    else:
        from ...models import AttnShiftDetector

        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        model = AttnShiftDetector(device=dev, dtype=dtype, **cfg.model.to_dict())
    model.init_weights(0)
    h, w = args.shape
    res = count(model, torch.zeros((1, h, w, 3), device=dev),
                torch.tensor([[float(w), float(h)]], device=dev))
    share = res["attention_flops"] / max(res["flops"], 1)
    print(f"input shape: (1, {h}, {w}, 3)")
    print(f"params: {res['params'] / 1e6:.2f} M")
    print(f"flops (FlopCounterMode): {res['flops'] / 1e9:.2f} GFLOPs")
    print(f"attention ops: {res['attention_flops'] / 1e9:.2f} GFLOPs ({share:.1%})")
    return res


if __name__ == "__main__":
    main()
