"""Native (C++) runtime components, bound via ctypes.

The port's own copy of ``attentionshift_tpu/native``. ``maskapi``: RLE
mask toolkit (encode/decode/area/IoU/polygon raster), the
pycocotools-maskApi equivalent the COCO path needs (see ``maskapi.cpp``).
Built with ``g++ -O3`` at first use into ``build/attentionshift_torch/``
at the repository root (listed in ``.gitignore``), under a name that
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. A pure-numpy fallback with
the same results keeps everything working if no compiler is available;
``native_available()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..ops._build import BUILD_DIR

__all__ = [
    "rle_encode",
    "rle_decode",
    "rle_area",
    "rle_iou_matrix",
    "rle_to_string",
    "rle_from_string",
    "polygons_to_mask",
    "native_available",
]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "maskapi.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> str:
    h = hashlib.sha1()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"maskapi-{h.hexdigest()[:12]}.so")


def _build(so: str) -> bool:
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so)  # atomic: concurrent builders each publish a whole library
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.rle_from_mask.restype = ctypes.c_int64
        lib.rle_from_mask.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, u32p]
        lib.rle_to_mask.restype = None
        lib.rle_to_mask.argtypes = [u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p]
        lib.rle_area.restype = ctypes.c_int64
        lib.rle_area.argtypes = [u32p, ctypes.c_int64]
        lib.rle_iou_matrix.restype = None
        lib.rle_iou_matrix.argtypes = [u32p, i64p, i64p, ctypes.c_int64,
                                       u32p, i64p, i64p, ctypes.c_int64,
                                       u8p, f64p]
        lib.rle_to_string.restype = ctypes.c_int64
        lib.rle_to_string.argtypes = [u32p, ctypes.c_int64, ctypes.c_char_p]
        lib.rle_from_string.restype = ctypes.c_int64
        lib.rle_from_string.argtypes = [ctypes.c_char_p, u32p]
        lib.polygon_to_mask.restype = None
        lib.polygon_to_mask.argtypes = [f64p, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, u8p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def rle_encode(mask: np.ndarray) -> dict:
    """(H, W) binary mask -> COCO RLE dict {'size': [h, w], 'counts': runs}."""
    h, w = mask.shape
    fortran = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    lib = _load()
    if lib is not None:
        fortran = np.ascontiguousarray(fortran)
        cnts = np.empty(h * w + 1, np.uint32)
        m = lib.rle_from_mask(_ptr(fortran, ctypes.c_uint8), h, w,
                              _ptr(cnts, ctypes.c_uint32))
        return {"size": [int(h), int(w)], "counts": cnts[:m].copy()}
    flat = fortran.astype(np.int8)
    changes = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], changes, [h * w]])
    runs = np.diff(bounds).astype(np.uint32)
    if flat[0] == 1:
        runs = np.concatenate([[np.uint32(0)], runs])
    return {"size": [int(h), int(w)], "counts": runs}


def rle_decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    cnts = np.ascontiguousarray(np.asarray(rle["counts"], np.uint32))
    lib = _load()
    if lib is not None:
        out = np.empty(h * w, np.uint8)
        lib.rle_to_mask(_ptr(cnts, ctypes.c_uint32), len(cnts), h, w,
                        _ptr(out, ctypes.c_uint8))
        return out.reshape(w, h).T.astype(bool)
    vals = np.zeros(len(cnts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, cnts)
    flat = np.pad(flat, (0, h * w - len(flat)))
    return flat.reshape(w, h).T.astype(bool)


def rle_area(rle: dict) -> int:
    cnts = np.asarray(rle["counts"], np.uint32)
    return int(cnts[1::2].sum())


def rle_iou_matrix(
    rles_a: list[dict], rles_b: list[dict], iscrowd_b=None
) -> np.ndarray:
    """Pairwise IoU without decoding (native) or with decode fallback.

    ``iscrowd_b`` marks columns as crowd regions: for those the score is
    intersection / area(a) — pycocotools `maskUtils.iou` crowd semantics
    (reference eval path: mmdet CocoDataset -> pycocotools COCOeval).
    """
    n, m = len(rles_a), len(rles_b)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    crowd = (np.zeros(m, np.uint8) if iscrowd_b is None
             else np.ascontiguousarray(np.asarray(iscrowd_b, np.uint8)))
    lib = _load()
    if lib is None:
        from ..eval.mean_ap_segm import mask_iou

        a = np.stack([rle_decode(r) for r in rles_a])
        b = np.stack([rle_decode(r) for r in rles_b])
        iou = mask_iou(a, b)
        if crowd.any():
            inter = np.einsum("nhw,mhw->nm", a.astype(np.float64),
                              b.astype(np.float64))
            area_a = a.reshape(n, -1).sum(-1).astype(np.float64)
            ioa = inter / np.maximum(area_a[:, None], 1.0)
            iou[:, crowd.astype(bool)] = ioa[:, crowd.astype(bool)]
        return iou

    def pack(rles):
        cnts = [np.ascontiguousarray(np.asarray(r["counts"], np.uint32)) for r in rles]
        lens = np.asarray([len(c) for c in cnts], np.int64)
        offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
        return np.concatenate(cnts).astype(np.uint32), offs, lens

    ca, oa, la = pack(rles_a)
    cb, ob, lb = pack(rles_b)
    out = np.empty((n, m), np.float64)
    lib.rle_iou_matrix(
        _ptr(ca, ctypes.c_uint32), _ptr(oa, ctypes.c_int64), _ptr(la, ctypes.c_int64), n,
        _ptr(cb, ctypes.c_uint32), _ptr(ob, ctypes.c_int64), _ptr(lb, ctypes.c_int64), m,
        _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double),
    )
    return out


def rle_to_string(rle: dict) -> bytes:
    cnts = np.ascontiguousarray(np.asarray(rle["counts"], np.uint32))
    lib = _load()
    if lib is not None:
        buf = ctypes.create_string_buffer(len(cnts) * 8 + 1)
        n = lib.rle_to_string(_ptr(cnts, ctypes.c_uint32), len(cnts), buf)
        return buf.raw[:n]
    out = bytearray()
    prev2 = {}
    for i, c in enumerate(cnts.tolist()):
        x = c - (int(cnts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def rle_from_string(s: bytes | str, size: list[int]) -> dict:
    if isinstance(s, str):
        s = s.encode()
    lib = _load()
    if lib is not None:
        cnts = np.empty(len(s) + 1, np.uint32)
        m = lib.rle_from_string(s, _ptr(cnts, ctypes.c_uint32))
        return {"size": list(size), "counts": cnts[:m].copy()}
    cnts = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return {"size": list(size), "counts": np.asarray(cnts, np.uint32)}


def polygons_to_mask(polys: list, h: int, w: int) -> np.ndarray:
    """COCO polygon list [[x0, y0, x1, y1, ...], ...] -> (H, W) bool mask."""
    out = np.zeros((h, w), np.uint8)
    lib = _load()
    for poly in polys:
        xy = np.ascontiguousarray(np.asarray(poly, np.float64))
        npts = len(xy) // 2
        if npts < 3:
            continue
        if lib is not None:
            m = np.zeros((h, w), np.uint8)
            lib.polygon_to_mask(_ptr(xy, ctypes.c_double), npts, h, w,
                                _ptr(m, ctypes.c_uint8))
            out |= m
        else:
            from PIL import Image, ImageDraw

            im = Image.new("L", (w, h), 0)
            ImageDraw.Draw(im).polygon(xy.reshape(-1, 2).tolist(), fill=1)
            out |= np.asarray(im, np.uint8)
    return out.astype(bool)
