"""Build every compiled library of the port ahead of a run. The port's twin
of ``tools/warm_cache.py``.

    python -m attentionshift_torch.tools.warm_cache [--device cpu]

The JAX tool warms XLA's persistent compile cache; the port compiles its
kernels instead: each ``csrc/*.cu`` with ``nvcc`` for ``sm_90a``
(``ops/_build.py::build_all``, one ``nvcc`` per source, all started
together) and the mask API ``native/maskapi.cpp`` with ``g++``, into the
gitignored ``build/attentionshift_torch/``. A library whose source,
headers and flags are unchanged is taken from there as it is. One line
per library: its file, whether it came from the cache or was built, and
the seconds its build took. On ``--device cpu`` only the mask API is
built: the CPU runs the kernels' plain versions. Without ``nvcc`` the
tool raises; it never reports a build it did not make.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import time


def _timed(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def warm_kernels() -> list:
    """Every kernel source through ``build_all``, one thread per source so
    that each build's own time is read; rows (library, cached, seconds)."""
    from ..ops import _build

    targets = [(s, ()) for s in sorted({k.source for k in _build.KERNELS.values()})]
    _build._nvcc()  # raises without the toolchain, before anything is reported
    cached = {t: os.path.exists(_build._target(*t)[1]) for t in targets}
    with concurrent.futures.ThreadPoolExecutor(len(targets)) as pool:
        secs = list(pool.map(lambda t: _timed(_build.build_all, [t]), targets))
    return [(_build._target(*t)[1], cached[t], s) for t, s in zip(targets, secs)]


def warm_native() -> tuple:
    from .. import native

    so = native._so_path()
    cached = os.path.exists(so)
    t0 = time.perf_counter()
    if not cached and not native._build(so):
        raise RuntimeError("g++ failed to build native/maskapi.cpp")
    return so, cached, time.perf_counter() - t0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Build the port's compiled libraries.")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Build; returns the rows (library path, from the cache, seconds)."""
    from ..device import resolve_device

    device = resolve_device(parse_args(argv).device)
    t0 = time.perf_counter()
    rows = (warm_kernels() if device.type == "cuda" else []) + [warm_native()]
    for path, cached, secs in rows:
        state = "cached" if cached else "built"
        print(f"[warm_cache] {os.path.basename(path):<40s} {state:<6s} {secs:7.1f} s", flush=True)
    print(f"[warm_cache] {len(rows)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


if __name__ == "__main__":
    main()
