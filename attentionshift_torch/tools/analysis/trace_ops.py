"""Aggregate per-kernel device time from a ``torch.profiler`` trace. The
port's twin of ``tools/analysis/trace_ops.py``.

    python -m attentionshift_torch.tools.analysis.trace_ops TRACE [--top 40] \\
        [--no-merge] [--lane kernel|cpu_op|...] [--device cpu]

``TRACE`` is a Chrome-format trace as ``torch.profiler``'s
``export_chrome_trace`` writes it (``.json`` or ``.json.gz``), or a
directory searched recursively for such files. The tool sums the
duration of every complete event (``"ph": "X"``) of one category, the
lane: ``kernel`` (the GPU kernels) by default on ``--device cuda``,
``cpu_op`` (the host's operators, what a trace of a CPU run holds) on
``--device cpu``; ``--lane`` picks another category (``gpu_memcpy``,
``cuda_runtime``, ...). The top rows are the optimisation worklist.

Instances of one kernel merge into one row by default: names that differ
only in template arguments (``<...>``), in the argument list of a
demangled signature (``(...)``) or in a numeric suffix (``.N``) are one
kernel (``--no-merge`` keeps them apart). Reading a trace needs no card.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

LANES = {"cuda": "kernel", "cpu": "cpu_op"}


def trace_files(path: str) -> list:
    if os.path.isfile(path):
        return [path]
    return sorted(p for pattern in ("*.json", "*.json.gz")
                  for p in glob.glob(os.path.join(path, "**", pattern), recursive=True))


def merged_name(name: str) -> str:
    """One row per kernel: template arguments, a signature's argument list
    and a numeric suffix dropped."""
    prev = None
    while prev != name:  # innermost template brackets first
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    name = re.sub(r"\([^()]*\)$", "", name.strip())
    return re.sub(r"\.\d+$", "", name).strip()


def aggregate(paths, lane: str, merge: bool = True):
    """(µs per name, number of events) of the ``lane`` events of ``paths``."""
    per_op = collections.Counter()
    n_events = 0
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            data = json.load(fh)
        events = data.get("traceEvents", []) if isinstance(data, dict) else data
        for e in events:
            if e.get("ph") != "X" or e.get("cat") != lane:
                continue
            per_op[merged_name(e["name"]) if merge else e["name"]] += e.get("dur", 0)
            n_events += 1
    return per_op, n_events


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Per-kernel time of a torch.profiler trace.")
    ap.add_argument("trace", help="a Chrome-format trace file or a directory of them")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--no-merge", action="store_true",
                    help="keep the instances of a kernel (template arguments, `.N`) separate")
    ap.add_argument("--lane", default=None,
                    help="event category to aggregate (default: kernel on cuda, cpu_op on cpu)")
    ap.add_argument("--device", default="cuda", choices=sorted(LANES),
                    help="the device the trace was taken on; picks the default lane")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool; returns the µs per row name and the event count."""
    args = parse_args(argv)
    lane = args.lane or LANES[args.device]
    paths = trace_files(args.trace)
    if not paths:
        raise SystemExit(f"no *.json or *.json.gz trace under {args.trace}")
    per_op, n_events = aggregate(paths, lane, merge=not args.no_merge)
    if not per_op:
        raise SystemExit(f"no '{lane}' events found in {paths}")
    total = sum(per_op.values())
    print(f"{n_events} {lane} events, total time {total / 1e3:.3f} ms (all steps summed)\n")
    print(f"{'op':<72s} {'ms':>9s} {'%':>6s}")
    for name, d in per_op.most_common(args.top):
        print(f"{name[:72]:<72s} {d / 1e3:9.3f} {100 * d / total:6.2f}")
    return dict(per_op=dict(per_op), n_events=n_events, lane=lane)


if __name__ == "__main__":
    main()
