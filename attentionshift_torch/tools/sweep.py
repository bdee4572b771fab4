"""Hyperparameter-sweep launcher: the port's twin of ``tools/sweep.py``.

    python -m attentionshift_torch.tools.sweep configs/attnshift_voc12aug.py \\
        --grid model.obj_tau=0.85,0.9,0.95 \\
        --grid model.num_semantic_points=3,5 \\
        --work-dir work_dirs/sweep [--dry-run] -- --max-steps 200

runs the cartesian product sequentially (6 runs here), each as
``python -m attentionshift_torch.tools.train CONFIG --work-dir
<work-dir>/<run-name> --cfg-options KEY=V ...`` with the overrides applied
through the config system's dotted paths, and prints a summary table of
the last logged train metrics (and eval metrics, when validation ran) per
combination. Everything after ``--`` is forwarded to the train CLI
verbatim. ``--dry-run`` prints the commands without running them.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys


def parse_args(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra: list[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description="Run the train CLI over a grid of config overrides.")
    p.add_argument("config")
    p.add_argument("--grid", action="append", default=[], metavar="KEY=V1,V2",
                   help="dotted config key with comma-separated values; "
                        "repeat for a cartesian product")
    p.add_argument("--work-dir", default="work_dirs/sweep")
    p.add_argument("--dry-run", action="store_true",
                   help="print the commands without running them")
    return p.parse_args(argv), extra


def _axes(grid_specs: list[str]) -> list[tuple[str, list[str]]]:
    axes = []
    for spec in grid_specs:
        key, _, vals = spec.partition("=")
        if not vals:
            raise SystemExit(f"--grid needs KEY=V1,V2,... (got {spec!r})")
        axes.append((key, vals.split(",")))
    return axes


def _run_name(combo: list[tuple[str, str]]) -> str:
    return "_".join(f"{k.rsplit('.', 1)[-1]}-{v}" for k, v in combo) or "base"


def _last_metrics(work_dir: str) -> dict:
    """Last ``train_log.jsonl`` record, merged with any eval records after it."""
    path = os.path.join(work_dir, "train_log.jsonl")
    out: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    out.update(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out


def commands(args, extra: list[str]) -> list[tuple[str, str, list[str]]]:
    """(run name, work dir, command) of each combination of the grid."""
    axes = _axes(args.grid)
    combos = [list(zip([k for k, _ in axes], vals))
              for vals in itertools.product(*[v for _, v in axes])] or [[]]
    out = []
    for combo in combos:
        name = _run_name(combo)
        wd = os.path.join(args.work_dir, name)
        cmd = [sys.executable, "-m", "attentionshift_torch.tools.train", args.config,
               "--work-dir", wd]
        if combo:
            cmd += ["--cfg-options"] + [f"{k}={v}" for k, v in combo]
        out.append((name, wd, cmd + extra))
    return out


def main(argv=None) -> list:
    """Run (or with ``--dry-run`` list) the sweep; returns (name, rc,
    last metrics) per run that ran."""
    args, extra = parse_args(argv)
    rows = []
    for name, wd, cmd in commands(args, extra):
        print(f"[sweep] {name}: {' '.join(cmd)}", flush=True)
        if args.dry_run:
            continue
        rc = subprocess.call(cmd)
        rows.append((name, rc, _last_metrics(wd)))
    if args.dry_run:
        return rows
    # summary table: union of the numeric metric keys, one row per run
    keys = sorted({k for _, _, m in rows for k, v in m.items() if isinstance(v, (int, float))})
    print("\n=== sweep summary ===")
    print("\t".join(["run", "rc"] + keys))
    for name, rc, m in rows:
        cells = [f"{m[k]:.4g}" if isinstance(m.get(k), (int, float)) else "-" for k in keys]
        print("\t".join([name, str(rc)] + cells))
    return rows


if __name__ == "__main__":
    main()
