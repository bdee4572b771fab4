"""Image resize with PyTorch ``F.interpolate`` sampling semantics.

Port of ``attentionshift_tpu/ops/image.py``: separable interpolation
weight matrices (half-pixel bilinear; bicubic with A=-0.75, clamp to
edge) applied as two matmuls in f32. The weight matrices are the JAX
package's, built in numpy, so both packages resample identically.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize", "resize_weight_matrix"]


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """PyTorch/OpenCV bicubic convolution kernel (A = -0.75)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _weight_matrix_np(in_size: int, out_size: int, method: str, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = dst * (in_size - 1) / (out_size - 1)
    else:
        src = (dst + 0.5) * (in_size / out_size) - 0.5
    if method == "nearest":
        idx = np.minimum((dst * (in_size / out_size)).astype(np.int64), in_size - 1)
        mat = np.zeros((out_size, in_size), dtype=np.float32)
        mat[np.arange(out_size), idx] = 1.0
        return mat
    if method in ("bilinear", "linear"):
        taps = 2

        def kern(x):
            return np.maximum(0.0, 1.0 - np.abs(x))

    elif method == "bicubic":
        taps = 4
        kern = _cubic_kernel
    else:
        raise ValueError(f"unknown resize method: {method}")
    base = np.floor(src).astype(np.int64)
    offsets = np.arange(-(taps // 2 - 1), taps // 2 + 1)
    idx = base[:, None] + offsets[None, :]
    w = kern(src[:, None] - idx)
    idx = np.clip(idx, 0, in_size - 1)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), taps), idx.reshape(-1)), w.reshape(-1))
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _weight_matrix(in_size, out_size, method, align_corners, device) -> torch.Tensor:
    return torch.from_numpy(_weight_matrix_np(in_size, out_size, method, align_corners)).to(device)


def resize_weight_matrix(in_size: int, out_size: int, method: str = "bilinear",
                         align_corners: bool = False, device="cpu") -> torch.Tensor:
    """Interpolation matrix ``W`` with ``out = W @ in`` along one axis."""
    return _weight_matrix(in_size, out_size, method, align_corners, torch.device(device))


def resize(img: torch.Tensor, out_shape: tuple[int, int], method: str = "bilinear",
           align_corners: bool = False) -> torch.Tensor:
    """Resize the last two axes of ``img``; leading axes are batch."""
    h_in, w_in = img.shape[-2], img.shape[-1]
    h_out, w_out = out_shape
    if (h_in, w_in) == (h_out, w_out):
        return img
    dtype = img.dtype
    lead = img.shape[:-2]
    x = img.float().reshape(-1, h_in, w_in)
    wh = resize_weight_matrix(h_in, h_out, method, align_corners, img.device)
    ww = resize_weight_matrix(w_in, w_out, method, align_corners, img.device)
    x = torch.matmul(wh, x)
    x = torch.matmul(x, ww.T)
    return x.reshape(*lead, h_out, w_out).to(dtype)
