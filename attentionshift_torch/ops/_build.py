"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into
``build/attentionshift_torch/`` at the repository root (listed in
``.gitignore``). The library name carries a hash of the source, so an
edited source is rebuilt and a stale library is never loaded.
``build_all`` starts one ``nvcc`` per source, all at once.

Every kernel has a ``Kernel`` record in ``KERNELS``: the wrapper adds
one to ``launches`` where it launches the kernel and nowhere else, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
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
    replaces: str  # file:line of the Pallas kernel in attentionshift_tpu
    launches: int = 0


KERNELS: dict[str, Kernel] = {
    k.name: k
    for k in (
        Kernel("attention_capture", "attention",
               "attentionshift_tpu/ops/attention.py:251"),
        Kernel("attention_plain", "attention",
               "attentionshift_tpu/ops/attention.py:315"),
        Kernel("ccl_batch", "ccl", "attentionshift_tpu/ops/ccl.py:200"),
        Kernel("meanshift_fixpoint", "meanshift",
               "attentionshift_tpu/ops/meanshift_kernel.py:47"),
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


def _target(source: str) -> tuple[str, str]:
    src = os.path.join(_CSRC, source + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha1(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"{source}-{digest}.so")


def _start(source: str):
    """Popen of the nvcc build of one source, or None when already built."""
    src, so = _target(source)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(source: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    out, _ = proc.communicate()
    _LIBS.logs[source] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{source}.cu:\n{out}")
    os.replace(tmp, so)


def build_all() -> dict[str, str]:
    """Build every csrc/*.cu in parallel; returns nvcc's output per source."""
    sources = sorted({k.source for k in KERNELS.values()})
    started = {s: _start(s) for s in sources}
    for s in sources:
        _finish(s, started[s])
    return {s: _LIBS.logs.get(s, "") for s in sources}


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built on first use."""
    lib = _LIBS.loaded.get(source)
    if lib is None:
        _finish(source, _start(source))
        lib = ctypes.CDLL(_target(source)[1])
        _LIBS.loaded[source] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
