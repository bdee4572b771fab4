"""Flax variables -> torch state dict for the pseudo-label path.

``flax_to_torch`` maps the JAX package's ``AttnShiftDetector`` variables
(``{"params": ..., "batch_stats": ...}``, leaves as numpy arrays of any
float dtype) onto ``attentionshift_torch.models.AttnShiftDetector``'s
state dict. Layout facts:

- Dense ``kernel`` (in, out) -> ``Linear.weight`` (out, in);
- the patch projection's conv-shaped (p, p, C, D) kernel, applied as
  space-to-depth + matmul, -> (D, p*p*C) with the (p, p, C) order kept;
- ``Deconv2x2Matmul`` applies its stored (2, 2, Cin, Cout) kernel
  spatially FLIPPED (flax ConvTranspose semantics), so the flip is made
  here, into ``ConvTranspose2d``'s (Cin, Cout, 2, 2) layout;
- ``fpn1_bn`` takes its running mean and var from ``batch_stats``;
- LayerNorm/BatchNorm ``scale`` -> ``weight``.

Subtrees of the train and test paths (``SKIPPED_SUBTREES``) are skipped
by name; any other unmapped key raises. ``load_flax`` loads strictly, so
a port parameter missing from the variables raises too.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SKIPPED_SUBTREES", "flax_to_torch", "load_flax"]

SKIPPED_SUBTREES = ("neck", "rpn_head", "bbox_head", "mask_head", "keypoint_align_head",
                    "mae_head", "reppoints_head_")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(path: tuple, value: np.ndarray):
    """(torch key, tensor) for one flax param path below ``params``."""
    x = np.asarray(value, dtype=np.float32)
    *mods, name = path
    key = []
    for m in mods:
        # blocks_3 -> blocks.3, layers_0 -> layers.0
        stem, _, idx = m.rpartition("_")
        key.extend([stem, idx] if stem in ("blocks", "layers") and idx.isdigit() else [m])
    if name == "kernel":
        if x.ndim == 2:
            return ".".join(key + ["weight"]), x.T
        if mods[-1] == "proj" and "patch_embed" in mods:
            return ".".join(key + ["weight"]), x.reshape(-1, x.shape[-1]).T
        if x.shape[:2] == (2, 2):
            return ".".join(key + ["weight"]), x[::-1, ::-1].transpose(2, 3, 0, 1)
        raise KeyError("/".join(path))
    if name == "scale":
        return ".".join(key + ["weight"]), x
    if name in ("bias", "cls_token", "pos_embed", "point_token", "point_pos_embed"):
        return ".".join(key + [name]), x
    raise KeyError("/".join(path))


def flax_to_torch(variables: dict) -> dict:
    """Flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch state dict."""
    params = variables.get("params", variables)
    sd = {}
    for path, value in _flatten(params):
        if path[0] in ("backbone", "mil_head"):
            try:
                key, arr = _leaf(path, value)
            except KeyError as e:
                raise KeyError(f"flax_to_torch: unmapped parameter {e.args[0]}") from None
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        elif not path[0].startswith(SKIPPED_SUBTREES):
            raise KeyError(f"flax_to_torch: unmapped parameter {'/'.join(path)}")
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[:2] != ("backbone", "fpn1_bn") or path[2] not in ("mean", "var"):
            if not path[0].startswith(SKIPPED_SUBTREES):
                raise KeyError(f"flax_to_torch: unmapped batch stat {'/'.join(path)}")
            continue
        sd[f"backbone.fpn1_bn.running_{path[2]}"] = torch.from_numpy(
            np.asarray(value, dtype=np.float32).copy())
    return sd


def load_flax(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Strictly load converted flax variables into ``model``."""
    model.load_state_dict(flax_to_torch(variables), strict=True)
    return model
