"""A numpy replay of flax's ``model.init`` parameter stream.

The JAX tools start their models from ``model.init({"params":
jax.random.PRNGKey(k), ...})``. This module recomputes those weights
without JAX, so that the port can start from exactly the weights a JAX
run started from (``tools/analysis/learning_check.py --init-jax-key``).

What flax and JAX 0.9.0 compute, and what is replayed here:

- the key of a parameter is ``fold_in(root, h)``, where ``h`` is the first
  four bytes (big-endian) of the SHA-1 of the scope path's names and of
  the parameter's position among the ``make_rng("params")`` calls of its
  scope (1, 2, ...; flax's ``LazyRng`` / ``_fold_in_static``, with
  ``flax_fix_rng_separator`` off, its default);
- ``fold_in`` and ``random_bits`` are Threefry-2x32 (20 rounds) under
  ``jax_threefry_partitionable`` (on by default in JAX 0.9.0): element i of
  a draw of any shape takes the counter (i >> 32, i & 0xffffffff) and its
  bits are the two output words XORed;
- ``uniform`` puts 23 random bits in the mantissa of a float in [1, 2),
  subtracts 1, scales to [minval, maxval) and clamps below at minval;
  ``normal`` is sqrt(2) erf_inv(uniform(-1 + ulp, 1)); ``truncated_normal``
  is sqrt(2) erf_inv(uniform(erf(lo / sqrt 2), erf(hi / sqrt 2))), clipped
  inside (lo, hi);
- the initialisers are ``jax.nn.initializers``: ``variance_scaling``
  (``lecun_normal`` = fan_in, truncated normal, divided by 0.8796...;
  ``xavier_uniform`` = fan_avg, uniform), ``normal(std)``,
  ``truncated_normal(std)``, zeros and ones.

Everything is f32 as in JAX. The integer arithmetic (the keys, the bits,
the uniform floats) is bitwise JAX's. ``erf_inv`` follows the f32
polynomial XLA lowers ``lax.erf_inv`` to (its steps fused multiply-adds,
as XLA's CPU code contracts them), with numpy's ``log1p``, so a normal
value can differ from XLA's by an ulp or two; the two truncation
bounds erf(+-sqrt 2) are XLA's f32 values.

The tree to draw comes from a manifest (``tools/fixtures/
flax_init_manifest.json``): each leaf's flax path, shape, position in its
scope and rule, listed from JAX on the CPU by ``tests/test_torch_flax_replay.py``,
with a fingerprint of key 0 (``fingerprint``) that the replay is held to.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable

import numpy as np

__all__ = ["MANIFEST", "prng_key", "threefry2x32", "fold_in", "split", "random_bits", "uniform",
           "normal", "truncated_normal", "erf_inv", "fold_in_static", "init_leaf",
           "load_manifest", "replay_variables", "fingerprint", "fingerprint_mismatches",
           "flatten"]

MANIFEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "fixtures", "flax_init_manifest.json")

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s raw key: (seed >> 32, seed & 0xffffffff)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32, 20 rounds, on uint32 arrays ``x0``, ``x1`` under the
    two-word ``key`` (JAX's ``threefry2x32_p``)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: Threefry of the counter (0, data)."""
    y0, y1 = threefry2x32(key, np.array([0], np.uint32), np.array([int(data) & 0xFFFFFFFF],
                                                                  np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (the partitionable form): (num, 2)."""
    y0, y1 = threefry2x32(key, *_counters(num))
    return np.stack([y0, y1], axis=1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (the partitionable form)."""
    n = int(np.prod(shape, dtype=np.int64))
    y0, y1 = threefry2x32(key, *_counters(n))
    return (y0 ^ y1).reshape(shape)


def _f32(x) -> np.float32:
    return np.float32(x)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in f32."""
    lo, hi = _f32(minval), _f32(maxval)
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - _f32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c) -> np.ndarray:
    """f32 a * b + c rounded once (XLA contracts the polynomial's steps):
    the f32 product is exact in f64."""
    return (np.asarray(a, np.float64) * b + np.asarray(c, np.float64)).astype(np.float32)


# XLA's f32 erf_inv (the chlo decomposition), two polynomials in w
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
               -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
               -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# XLA's f32 log1p on the CPU: below sqrt(2) - 1 in magnitude Cephes' rational
# log1p (numerator and denominator highest degree first), above it Cephes'
# logf of 1 + x (frexp-style split, a degree-8 polynomial, ln 2 in two parts)
_LOG1P_P = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1, 6.5787325942061044846969E0,
            2.9911919328553073277375E1, 6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)
_LOG1P_Q = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1, 2.2176239823732856465394E2,
            3.0909872225312059774938E2, 2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1, 1.4249322787E-1,
           -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _logf(x: np.ndarray) -> np.ndarray:
    """Cephes' logf as XLA's CPU code computes it (x > 0 finite)."""
    t = np.maximum(_f32(1.17549435e-38), x)
    e = _f32(1.0) + ((t.view(np.int32) >> 23) - 0x7F).astype(np.float32)
    t = ((t.view(np.uint32) & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(np.float32)
    below = t < _f32(0.707106781186547524)
    t = (t - _f32(1.0)) + np.where(below, t, _f32(0.0))
    e = e - np.where(below, _f32(1.0), _f32(0.0))
    x2 = t * t
    x3 = x2 * t
    p = [_f32(c) for c in _LOGF_P]
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f32(-2.12194440e-4) * e)
    t = (t - _f32(0.5) * x2) + y
    return t + _f32(0.693359375) * e


def _poly(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _f32(c))
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    """f32 log1p as XLA's CPU code computes it, for x in (-1, 1); each
    branch evaluated on its own entries."""
    out = np.empty_like(x)
    small = np.abs(x) < _f32(0.41421356237309504880)
    xs = x[small]
    x2 = xs * xs
    out[small] = xs + _fma(_f32(-0.5), x2,
                           (xs * x2) * (_poly(xs, _LOG1P_P) / _poly(xs, _LOG1P_Q)))
    out[~small] = _logf(x[~small] + _f32(1.0))
    return out


def erf_inv(x: np.ndarray) -> np.ndarray:
    """f32 erf^-1 by XLA's formula: w = -log1p(-x^2); below 5 a polynomial
    in w - 2.5, else in sqrt(w) - 3; times x; +-inf at +-1."""
    x = np.asarray(x, np.float32)
    w = -_log1p(x * -x)
    p = np.empty_like(x)
    lt = w < _f32(5.0)
    for sel, shift, coeffs in ((lt, lambda v: v - _f32(2.5), _ERFINV_LT5),
                               (~lt, lambda v: np.sqrt(v) - _f32(3.0), _ERFINV_GE5)):
        v = shift(w[sel])
        q = np.full_like(v, _f32(coeffs[0]))
        for c in coeffs[1:]:
            q = _fma(q, v, _f32(c))
        p[sel] = q
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == _f32(1.0), x * _f32(np.inf), p * x).astype(np.float32)


_SQRT2 = _f32(np.sqrt(2.0))
# XLA's f32 erf at -2 / sqrt(2) and 2 / sqrt(2) (the bounds of a normal cut at
# two standard deviations), bit patterns as JAX 0.9.0 computes them on the CPU
_ERF_AT = {-2.0: np.array(0xBF745A18, np.uint32).view(np.float32),
           2.0: np.array(0x3F745A18, np.uint32).view(np.float32)}


def normal(key, shape, scale: float = 1.0) -> np.ndarray:
    """``jax.random.normal`` in f32, times ``scale``: XLA folds sqrt(2) *
    scale into one constant, so the product is erf_inv(u) * f32(sqrt(2) *
    scale)."""
    lo = np.nextafter(_f32(-1.0), _f32(0.0))
    return erf_inv(uniform(key, shape, lo, 1.0)) * (_SQRT2 * _f32(scale))


def truncated_normal(key, lower: float, upper: float, shape) -> np.ndarray:
    """``jax.random.truncated_normal`` in f32 (bounds +-2 only: the ones the
    JAX modules use)."""
    a, b = _ERF_AT[float(lower)], _ERF_AT[float(upper)]
    out = _SQRT2 * erf_inv(uniform(key, shape, a, b))
    lo, hi = _f32(lower), _f32(upper)
    return np.clip(out, np.nextafter(lo, _f32(np.inf)), np.nextafter(hi, _f32(-np.inf)))


def fold_in_static(key, data: Iterable) -> np.ndarray:
    """flax's ``_fold_in_static``: fold the first 4 bytes of the SHA-1 of
    the names (utf-8) and counters (big-endian, minimal bytes) in."""
    m = hashlib.sha1()
    any_data = False
    for x in data:
        any_data = True
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            x = int(x)
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    if not any_data:
        return np.asarray(key, np.uint32)
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def _fans(shape, in_axis: int = -2, out_axis: int = -1) -> tuple[float, float]:
    receptive = float(np.prod(shape)) / shape[in_axis] / shape[out_axis]
    return shape[in_axis] * receptive, shape[out_axis] * receptive


def init_leaf(key, rule: dict, shape) -> np.ndarray:
    """One parameter by its manifest rule (``kind`` and the initialiser's
    arguments), from its folded key."""
    shape = tuple(int(s) for s in shape)
    kind = rule["kind"]
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "ones":
        return np.ones(shape, np.float32)
    if kind == "normal":
        return normal(key, shape, rule["stddev"])
    if kind == "truncated_normal":
        return truncated_normal(key, rule["lower"], rule["upper"], shape) * _f32(rule["stddev"])
    if kind == "variance_scaling":
        fan_in, fan_out = _fans(shape, rule["in_axis"], rule["out_axis"])
        denom = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[rule["mode"]]
        variance = _f32(rule["scale"] / denom)
        if rule["distribution"] == "truncated_normal":
            std = np.sqrt(variance) / _f32(0.87962566103423978)
            return truncated_normal(key, -2.0, 2.0, shape) * std
        if rule["distribution"] == "normal":
            return normal(key, shape, np.sqrt(variance))
        if rule["distribution"] == "uniform":
            return uniform(key, shape, -1.0, 1.0) * np.sqrt(_f32(3.0) * variance)
    raise ValueError(f"flax_replay: no rule {rule}")


def load_manifest(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _put(tree: dict, path, value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def replay_variables(manifest: dict, key: int) -> dict:
    """``{"params": ..., "batch_stats": ...}`` as the manifest's model's
    ``model.init`` with ``PRNGKey(key)`` gives them, as numpy f32 trees.
    ``convert.load_flax`` carries them into the port's model."""
    root = prng_key(key)
    out: dict = {}
    for leaf in manifest["leaves"]:
        path = leaf["path"].split("/")  # collection, scope path, name
        k = None if leaf["counter"] is None else fold_in_static(
            root, [*path[1:-1], int(leaf["counter"])])
        _put(out, path, init_leaf(k, leaf["rule"], leaf["shape"]))
    return out


def flatten(tree: dict, prefix=()):
    """(path "a/b/c", leaf) pairs of a nested dict, in key order."""
    for name in sorted(tree):
        v = tree[name]
        if isinstance(v, dict):
            yield from flatten(v, prefix + (name,))
        else:
            yield "/".join(prefix + (name,)), v


def fingerprint(tree: dict) -> dict:
    """Per leaf: the f64 sum, the f64 sum of squares and the first 8 values."""
    fp = {}
    for path, v in flatten(tree):
        a = np.asarray(v, np.float32).ravel()
        fp[path] = {"sum": float(a.astype(np.float64).sum()),
                    "sumsq": float(np.square(a.astype(np.float64)).sum()),
                    "head": [float(x) for x in a[:8]]}
    return fp


def fingerprint_mismatches(tree: dict, want: dict, ulps: int = 2) -> list[str]:
    """The leaves of ``tree`` that differ from the fingerprint ``want``:
    the first 8 values each within ``ulps`` f32 ulps of their own size, and
    the sum and the sum of squares within ``ulps`` ulps of the sum of
    |x| (x^2), which bounds what that many ulps per value can move them."""
    got = fingerprint(tree)
    bad = sorted(set(got) ^ set(want))
    for path in sorted(set(got) & set(want)):
        g, w = got[path], want[path]
        gh, wh = np.asarray(g["head"], np.float32), np.asarray(w["head"], np.float32)
        if gh.shape != wh.shape or np.any(np.abs(gh - wh) > ulps * np.spacing(np.abs(wh))):
            bad.append(f"{path}: head")
            continue
        eps = float(np.finfo(np.float32).eps)
        scale = np.sqrt(w["sumsq"] * _count(path, tree))
        if abs(g["sum"] - w["sum"]) > ulps * eps * scale + 1e-30:
            bad.append(f"{path}: sum {g['sum']} vs {w['sum']}")
        elif abs(g["sumsq"] - w["sumsq"]) > 2 * ulps * eps * w["sumsq"] + 1e-30:
            bad.append(f"{path}: sumsq {g['sumsq']} vs {w['sumsq']}")
    return bad


def _count(path: str, tree: dict) -> int:
    for name in path.split("/"):
        tree = tree[name]
    return int(np.size(tree))
