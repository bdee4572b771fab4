"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into
``build/attentionshift_torch/`` at the repository root (listed in
``.gitignore``). The library name carries a hash of the source and of
every header it includes with quotes (``csrc/*.cuh``, transitively), so
an edited source or header is rebuilt and a stale library is never
loaded. TMA tensor maps are encoded through the entry point that
``cudaGetDriverEntryPoint`` returns, so nothing links against ``libcuda``.
``build_all`` starts one ``nvcc`` per source, all at once. A source may
also be built with ``-D`` overrides of the design constants it guards
with ``#ifndef`` (``library(source, defines)``): a library of its own,
whose name hashes the overrides too.

Every kernel has a ``Kernel`` record in ``KERNELS``: the wrapper adds
one to ``launches`` where it launches the kernel and nowhere else, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from dataclasses import dataclass, field

__all__ = ["Kernel", "KERNELS", "build_all", "library", "check", "reset_launches"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "attentionshift_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]


@dataclass
class Kernel:
    """One hand-written kernel and the TPU kernel it replaces."""

    name: str
    source: str  # csrc file stem
    replaces: str  # file:line of the Pallas kernel in the JAX package or its tools
    launches: int = 0


KERNELS: dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel("attention_capture", "attention",
               "attentionshift_tpu/ops/attention.py:251"),
        Kernel("attention_plain", "attention",
               "attentionshift_tpu/ops/attention.py:315"),
        Kernel("attention_bwd_dq", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:364"),
        Kernel("attention_bwd_dkv", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:402"),
        # the same four kernels' head-dim-32 instances (Swin's global blocks)
        Kernel("attention_capture_d32", "attention",
               "attentionshift_tpu/ops/attention.py:251"),
        Kernel("attention_plain_d32", "attention",
               "attentionshift_tpu/ops/attention.py:315"),
        Kernel("attention_bwd_dq_d32", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:364"),
        Kernel("attention_bwd_dkv_d32", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:402"),
        # at head dim 32 and T <= 64 one kernel gives dQ, dK and dV in one pass
        # (bwd32_short): it replaces _bwd_kernel_dq (:364) and _bwd_kernel_dkv (:402) at once
        Kernel("attention_bwd_d32_short", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:364"),
        # their head-dim-128 instances (head dims 72-128 through ops/attention.py's route)
        Kernel("attention_capture_d128", "attention",
               "attentionshift_tpu/ops/attention.py:251"),
        Kernel("attention_plain_d128", "attention",
               "attentionshift_tpu/ops/attention.py:315"),
        Kernel("attention_bwd_dq_d128", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:364"),
        Kernel("attention_bwd_dkv_d128", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:402"),
        # their wide route (head dims above 128, padded to a multiple of 128)
        Kernel("attention_capture_dwide", "attention",
               "attentionshift_tpu/ops/attention.py:251"),
        Kernel("attention_plain_dwide", "attention",
               "attentionshift_tpu/ops/attention.py:315"),
        Kernel("attention_bwd_dq_dwide", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:364"),
        Kernel("attention_bwd_dkv_dwide", "attention_bwd",
               "attentionshift_tpu/ops/attention.py:402"),
        Kernel("ccl_batch", "ccl", "attentionshift_tpu/ops/ccl.py:200"),
        Kernel("meanshift_fixpoint", "meanshift",
               "attentionshift_tpu/ops/meanshift_kernel.py:47"),
        # its second route: more prototypes than the cluster kernel holds (K > 32)
        Kernel("meanshift_fixpoint_kwide", "meanshift",
               "attentionshift_tpu/ops/meanshift_kernel.py:47"),
        # the attention microbenchmark's design variants of the capture kernel
        Kernel("attention_v2_bf16e", "attention_variants",
               "tools/analysis/microbench_attention.py:171"),
        Kernel("attention_v3_nomin", "attention_variants",
               "tools/analysis/microbench_attention.py:224"),
        Kernel("attention_v4_mxsum", "attention_variants",
               "tools/analysis/microbench_attention.py:282"),
        Kernel("attention_v5_batched", "attention_variants",
               "tools/analysis/microbench_attention.py:337"),
        Kernel("attention_v6_fusedsum", "attention_variants",
               "tools/analysis/microbench_attention.py:393"),
        # the variants' head-dim-32 and -128 instances (head dims 1-32 and
        # 65-128 through ops/attention_variants.py's padding) and their wide
        # route (head dims above 128, padded to a multiple of 128)
        *(Kernel(f"{name}_{d}", "attention_variants", f"tools/analysis/microbench_attention.py:{line}")
          for d in ("d32", "d128", "dwide")
          for name, line in (("attention_v2_bf16e", 171), ("attention_v3_nomin", 224),
                             ("attention_v4_mxsum", 282), ("attention_v5_batched", 337),
                             ("attention_v6_fusedsum", 393))),
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


@dataclass
class _Libraries:
    loaded: dict = field(default_factory=dict)
    logs: dict = field(default_factory=dict)


_LIBS = _Libraries()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _digest(src: str, defines: tuple = ()) -> str:
    """Hash of ``src``, of every header it includes with quotes (resolved
    beside the including file, transitively), of the nvcc flags and of the
    ``-D`` overrides."""
    h = hashlib.sha1()
    seen, todo = set(), [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as fh:
            text = fh.read()
        h.update(text)
        todo += [os.path.join(os.path.dirname(path), m.decode()) for m in _INCLUDE.findall(text)]
    h.update(" ".join(NVCC_FLAGS + [f"-D{d}" for d in defines]).encode())
    return h.hexdigest()[:12]


def _target(source: str, defines: tuple = ()) -> tuple[str, str]:
    src = os.path.join(_CSRC, source + ".cu")
    return src, os.path.join(BUILD_DIR, f"{source}-{_digest(src, defines)}.so")


def _start(source: str, defines: tuple = ()):
    """Popen of the nvcc build of one source, or None when already built."""
    src, so = _target(source, defines)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(target: tuple, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    out, _ = proc.communicate()
    _LIBS.logs[target] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{target[0]}.cu {' '.join(target[1])}:\n{out}")
    os.replace(tmp, so)


def build_all(targets=None) -> dict:
    """Build every csrc/*.cu, or each (source, defines) of ``targets``, in
    parallel; returns nvcc's output per (source, defines)."""
    if targets is None:
        targets = [(s, ()) for s in sorted({k.source for k in KERNELS.values()})]
    started = {t: _start(*t) for t in targets}
    for t in targets:
        _finish(t, started[t])
    return {t: _LIBS.logs.get(t, "") for t in targets}


def library(source: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu`` (with the ``-D``
    overrides ``defines``, e.g. ``("FWD_STAGES=3",)``), built on first use."""
    key = (source, tuple(defines))
    lib = _LIBS.loaded.get(key)
    if lib is None:
        _finish(key, _start(*key))
        lib = ctypes.CDLL(_target(*key)[1])
        _LIBS.loaded[key] = lib
    return lib


# codes >= 998 of csrc/hopper.cuh's make_tile_map: no TMA tensor map
_TMA_CODES = {999: "the driver has no entry point cuTensorMapEncodeTiled",
              998: "a tensor is not 16-byte aligned"}


def check(err: int, what: str) -> None:
    """Raise on a non-zero return of a launch: a ``cudaError_t``, or a code
    >= 998 that says why a TMA tensor map could not be made."""
    if err >= 998:
        why = _TMA_CODES.get(err, f"the driver refused it with CUresult {err - 1000}")
        raise RuntimeError(f"{what}: no TMA tensor map could be made ({why}; code {err})")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
