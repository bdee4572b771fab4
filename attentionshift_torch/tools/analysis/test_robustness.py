"""Corruption-robustness benchmark: the port's twin of
``tools/analysis/test_robustness.py``.

Evaluates the model on the clean val set (performance P) and on each
requested corruption x severity (``data/corruptions.py``), then reports
the corruption benchmark summary: per-corruption mean AP over severities
(PC), mean PC across corruptions (mPC), and relative mPC / P (rPC).

    python -m attentionshift_torch.tools.analysis.test_robustness CONFIG [CHECKPOINT] \\
        [--corruptions gaussian_noise motion_blur ...] [--severities 1 3 5] \\
        [--metric mAP@0.5] [--limit N] [--out F] [--cfg-options ...] [--device cpu]

The model, dataset and checkpoint handling are ``tools.test``'s (without a
checkpoint every parameter is zero, as in the JAX tool); evaluation is
``eval/runner.py::evaluate``. The summary is the only column-0 JSON
object the tool prints.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    from ...data.corruptions import CORRUPTIONS

    p = argparse.ArgumentParser(description="P, PC, mPC and rPC over image corruptions.")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--corruptions", nargs="*", default=sorted(CORRUPTIONS),
                   choices=sorted(CORRUPTIONS))
    p.add_argument("--severities", type=int, nargs="*", default=[1, 2, 3, 4, 5])
    p.add_argument("--metric", default="mAP@0.5",
                   help="key of the evaluate() result used for the summary")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--out", default=None, help="dump the full table as json")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark on ``argv``; returns the table and the summary."""
    from ...data.corruptions import CorruptedDataset
    from ...eval.runner import evaluate
    from .. import test as cli

    args = parse_args(argv)
    test_argv = [args.config] + ([args.checkpoint] if args.checkpoint else [])
    test_argv += ["--cfg-options", *args.cfg_options]
    if args.device:
        test_argv += ["--device", args.device]
    cfg, model, dataset, _ = cli.build(cli.parse_args(test_argv))

    def run(ds):
        res = evaluate(model, ds, test_scale=tuple(cfg.data.test_scale), limit=args.limit,
                       num_classes=int(cfg.model.num_classes), verbose=False)
        return float(res[args.metric])

    table = {"clean": run(dataset)}
    print(f"clean {args.metric}: {table['clean']:.4f}", flush=True)
    for name in args.corruptions:
        per_sev = {}
        for sev in args.severities:
            per_sev[sev] = run(CorruptedDataset(dataset, name, sev))
            print(f"{name} s{sev}: {per_sev[sev]:.4f}", flush=True)
        table[name] = per_sev

    pcs = {n: float(np.mean(list(v.values()))) for n, v in table.items() if n != "clean"}
    summary = dict(P=table["clean"], PC=pcs,
                   mPC=float(np.mean(list(pcs.values()))) if pcs else None)
    if pcs and table["clean"] > 0:
        summary["rPC"] = summary["mPC"] / table["clean"]
    out = dict(metric=args.metric, table=table, summary=summary)
    print(json.dumps(out["summary"], indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
