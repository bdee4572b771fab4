"""Flax variables -> torch state dict for the train and pseudo-label paths.

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
- LayerNorm/BatchNorm ``scale`` -> ``weight``;
- 1x1 conv kernels (1, 1, Cin, Cout) -> ``Linear.weight`` (Cout, Cin);
  3x3 conv kernels keep their (3, 3, Cin, Cout) layout for
  ``Conv3x3Matmul``;
- ``lateral_i`` / ``fpn_conv_i`` / ``decoder_blocks_i`` -> module lists,
  and the flax auto-named ``Dense_i`` of the keypoint head's MLP ->
  ``layers.i``;
- the train variants' heads map by the same rules: ``reppoints_head_i``
  (``conv_i`` 3x3, ``gn_i`` scale and bias, the 1x1 ``cls_out`` and
  ``pts_out``), ``keypoint_align_head`` and ``mae_head`` (its
  ``mask_token`` as it is).

Any unmapped key raises, and ``load_flax`` loads strictly, so a port
parameter missing from the variables raises too.

``model_type="swin"`` maps the JAX ``SwinTransformer``'s variables onto
``attentionshift_torch.models.swin.SwinTransformer`` by the same rules:
the ``patch_embed`` conv kernel (p, p, 3, D) -> ``Conv2d``'s (D, 3, p, p);
Dense kernels transposed (``merge{st}.reduction`` has no bias); LayerNorm
``scale`` -> ``weight``; ``relative_position_bias_table``,
``point_token`` and ``point_pos_embed`` as they are; ``stage{st}_block{i}``,
``out_norm{st}``, ``merge{st}``, ``global_block{i}``, ``class_embed`` and
``bbox_embed`` keep their names.

``model_type`` ``"mae_encoder"``, ``"mim_vit"``, ``"dino_head"``,
``"ibot_head"`` and ``"deformable_attention"`` map the JAX modules of
those names onto their twins in ``attentionshift_torch/models`` by the
same rules, plus: ``tapnorm_i`` -> a module list; the LayerScale vectors
``gamma_1`` / ``gamma_2`` and the prototype layers' ``weight_v`` /
``weight_g`` as they are; the heads' Dense trunk ``mlp`` / ``mlp_i`` ->
``trunk.mlp.i``; the depthwise (3, 3, 1, C) conv kernels of the
deformable attention -> ``Conv2d``'s (C, 1, 3, 3) with ``groups=C``; and
every BatchNorm's ``batch_stats`` ``mean`` / ``var`` -> its
``running_mean`` / ``running_var`` (the MAE encoder's ``fpn1_bn``).

``model_type="mask_rcnn"`` maps the JAX ``MaskRCNN``'s variables onto
``attentionshift_torch.models.mask_rcnn.MaskRCNN``: the ResNet backbone by
its own rules (every conv kernel (kh, kw, Cin, Cout) -> ``Conv2d``'s
(Cout, Cin, kh, kw), the 7x7 stem and the 1x1 stride-2 ``downsample_conv``
included; ``layer{s}_{b}`` -> ``layer{s}.{b}``; ``downsample_conv`` /
``downsample_bn`` -> ``downsample.0`` / ``.1``; the ``FrozenBN`` vectors
``scale``, ``bias``, ``mean``, ``var``, which flax keeps under ``params``,
-> the buffers ``weight``, ``bias``, ``running_mean``, ``running_var``),
the neck, RPN, box and mask heads by the rules above (the mask head's
``ConvTranspose`` kernel flipped).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["MAPPED_SUBTREES", "flax_to_torch", "load_flax"]

# top-level subtrees of the detector's variables; reppoints_head_i by prefix
MAPPED_SUBTREES = ("backbone", "mil_head", "neck", "rpn_head", "bbox_head", "mask_head",
                   "keypoint_align_head", "mae_head", "reppoints_head_")
_LISTS = ("blocks", "layers", "lateral", "fpn_conv", "decoder_blocks", "tapnorm")
# model types whose every parameter maps by ``_leaf`` (``_module_to_torch``)
_MODULE_TYPES = ("swin", "mae_encoder", "mim_vit", "dino_head", "ibot_head",
                 "deformable_attention")


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
        if stem == "Dense" and idx.isdigit():
            key.extend(["layers", idx])
        else:
            key.extend([stem, idx] if stem in _LISTS and idx.isdigit() else [m])
    if name == "kernel":
        if mods[-1] == "patch_embed" and x.ndim == 4:  # Swin's stride-p conv
            return ".".join(key + ["weight"]), x.transpose(3, 2, 0, 1)
        if x.ndim == 2:
            return ".".join(key + ["weight"]), x.T
        if mods[-1] == "proj" and "patch_embed" in mods:
            return ".".join(key + ["weight"]), x.reshape(-1, x.shape[-1]).T
        if x.shape[:2] == (2, 2):
            return ".".join(key + ["weight"]), x[::-1, ::-1].transpose(2, 3, 0, 1)
        if x.shape[:2] == (1, 1):
            return ".".join(key + ["weight"]), x[0, 0].T
        if x.shape[:2] == (3, 3):
            return ".".join(key + ["weight"]), x
        raise KeyError("/".join(path))
    if name == "scale":
        return ".".join(key + ["weight"]), x
    if name in ("bias", "cls_token", "pos_embed", "point_token", "point_pos_embed", "det_token",
                "mask_token", "relative_position_bias_table", "gamma_1", "gamma_2", "weight_v",
                "weight_g"):
        return ".".join(key + [name]), x
    raise KeyError("/".join(path))


_FROZEN_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _resnet_leaf(path: tuple, value: np.ndarray):
    """(torch key, tensor) for one flax ``ResNet`` param path (below
    ``backbone``)."""
    x = np.asarray(value, dtype=np.float32)
    *mods, name = path
    key = []
    for m in mods:
        stem, _, idx = m.rpartition("_")
        if stem.startswith("layer") and idx.isdigit():
            key.extend([stem, idx])
        elif m in ("downsample_conv", "downsample_bn"):
            key.extend(["downsample", "0" if m == "downsample_conv" else "1"])
        else:
            key.append(m)
    if name == "kernel" and x.ndim == 4:
        return ".".join(key + ["weight"]), x.transpose(3, 2, 0, 1)
    if name in _FROZEN_BN:
        return ".".join(key + [_FROZEN_BN[name]]), x
    raise KeyError("/".join(path))


def flax_to_torch(variables: dict, model_type: str = "attnshift") -> dict:
    """Flax ``{"params", "batch_stats"}`` (numpy leaves) -> torch state dict
    of the port's ``AttnShiftDetector`` or, with another ``model_type``,
    of the port's module of that name."""
    if model_type == "mask_rcnn":
        return _mask_rcnn_to_torch(variables.get("params", variables))
    if model_type in _MODULE_TYPES:
        return _module_to_torch(variables, model_type)
    if model_type != "attnshift":
        raise ValueError(f"flax_to_torch: unknown model_type {model_type!r}")
    params = variables.get("params", variables)
    sd = {}
    for path, value in _flatten(params):
        if not path[0].startswith(MAPPED_SUBTREES):
            raise KeyError(f"flax_to_torch: unmapped parameter {'/'.join(path)}")
        try:
            key, arr = _leaf(path, value)
        except KeyError as e:
            raise KeyError(f"flax_to_torch: unmapped parameter {e.args[0]}") from None
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[:2] != ("backbone", "fpn1_bn") or path[2] not in ("mean", "var"):
            raise KeyError(f"flax_to_torch: unmapped batch stat {'/'.join(path)}")
        sd[f"backbone.fpn1_bn.running_{path[2]}"] = torch.from_numpy(
            np.asarray(value, dtype=np.float32).copy())
    return sd


def _module_to_torch(variables: dict, model_type: str) -> dict:
    sd = {}
    for path, value in _flatten(variables.get("params", variables)):
        if model_type in ("dino_head", "ibot_head") and path[0].startswith("mlp"):
            path = ("trunk", "mlp", path[0][4:] or "0") + path[1:]
        try:
            if path[-1] == "kernel" and np.shape(value)[:3] == (3, 3, 1) \
                    and model_type == "deformable_attention":  # depthwise
                key = ".".join(path[:-1] + ("weight",))
                arr = np.asarray(value, np.float32).transpose(3, 2, 0, 1)
            else:
                key, arr = _leaf(path, value)
        except KeyError as e:
            raise KeyError(f"flax_to_torch: unmapped parameter {e.args[0]}") from None
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[-1] not in ("mean", "var"):
            raise KeyError(f"flax_to_torch: unmapped batch stat {'/'.join(path)}")
        sd[".".join(path[:-1]) + f".running_{path[-1]}"] = torch.from_numpy(
            np.asarray(value, dtype=np.float32).copy())
    return sd


def _mask_rcnn_to_torch(params: dict) -> dict:
    sd = {}
    for path, value in _flatten(params):
        try:
            if path[0] == "backbone":
                key, arr = _resnet_leaf(path[1:], value)
                key = "backbone." + key
            elif path[0] in ("neck", "rpn_head", "bbox_head", "mask_head"):
                key, arr = _leaf(path, value)
            else:
                raise KeyError("/".join(path))
        except KeyError as e:
            raise KeyError(f"flax_to_torch: unmapped parameter {e.args[0]}") from None
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def load_flax(model: torch.nn.Module, variables: dict,
              model_type: str = "attnshift") -> torch.nn.Module:
    """Strictly load converted flax variables into ``model``."""
    model.load_state_dict(flax_to_torch(variables, model_type), strict=True)
    return model
