"""Torch MAE / torchvision checkpoints -> the port's backbones.

Port of ``attentionshift_tpu/models/convert.py`` (the pretrain inits
of ``tools/train.py``), replacing the reference's
``load_checkpoint(strict=False)`` (`mmcv_custom/checkpoint.py:286-358`):
an MAE encoder ``state_dict`` is grafted onto
``VisionTransformerDet``'s parameters, with the bicubic pos-embed
re-interpolation of the forward when the stored grid differs. Keys that
MAE lacks (the point tokens, ``point_pos_embed``, the FPN taps and the
point heads) keep their init, as with strict=False.

The graft composes two mappings that already exist rather than writing a
third: MAE's torch names and layouts -> the flax leaf layout of the JAX
package's ``mae_to_vit_params`` -> the port's names and layouts through
``attentionshift_torch.convert._leaf`` (which knows, for instance, that
the port's ``PatchEmbed`` is a space-to-depth and one matmul whose input
axis is ordered (p, p, C)).

``mae_to_decoder_params`` grafts an MAE *decoder* ``state_dict`` onto a
decoder-style head (``BoxHeadRec``, ``MaskHeadPointSup``,
``MAEDecoderHead``): as the reference heads load every checkpoint key but
the encoder's, ``decoder_embed``, ``norm`` and ``decoder_blocks.N.*``
land in the head. The port's heads use MAE's own names and layouts, so
each tensor is copied as it is.

``torchvision_resnet_params`` grafts a torchvision ResNet ``state_dict``
onto the refinement stage's ``models.resnet.ResNet``, whose names and
layouts are torchvision's: the BatchNorm running statistics land in the
``FrozenBN`` buffers, ``fc.*`` and ``num_batches_tracked`` are dropped,
and keys the checkpoint lacks keep their init (strict=False).
"""

from __future__ import annotations

import hashlib
import os
import urllib.parse
import urllib.request
import warnings
from typing import Dict, Mapping

import numpy as np
import torch

from ..convert import _leaf
from .layers import interpolate_pos_embed

__all__ = ["load_torch_state_dict", "resolve_checkpoint_path", "mae_to_vit_params",
           "mae_to_decoder_params", "torchvision_resnet_params"]


def resolve_checkpoint_path(path: str, cache_dir: str | None = None,
                            sha256: str | None = None) -> str:
    """Resolve a checkpoint spec to a local file path.

    Plain paths load directly; ``http(s)://`` and ``file://`` URLs are
    fetched once into ``cache_dir`` (default
    ``~/.cache/attentionshift_torch/checkpoints``, override with
    $ATTNSHIFT_CKPT_CACHE) and reused on later calls, each entry keyed by
    ``<sha256(full URL)[:16]>-<basename>`` so that two URLs sharing a file
    name never collide. ``sha256``, when given, is checked against the
    cached file's digest: a mismatch deletes the entry and raises.
    pavi:// and s3:// raise (proprietary clients,
    `mmcv_custom/checkpoint.py:300-338`).
    """
    scheme = urllib.parse.urlparse(path).scheme
    if scheme in ("", None) or len(scheme) <= 1:  # plain / drive-letter path
        return path
    if scheme in ("pavi", "s3"):
        raise NotImplementedError(
            f"{scheme}:// checkpoint backends need proprietary clients "
            "(reference: mmcv_custom/checkpoint.py:300-338); download the "
            "file and pass a local or http(s):// path instead"
        )
    if scheme not in ("http", "https", "file"):
        raise ValueError(f"unsupported checkpoint URL scheme: {path}")
    cache_dir = (cache_dir or os.environ.get("ATTNSHIFT_CKPT_CACHE")
                 or os.path.expanduser("~/.cache/attentionshift_torch/checkpoints"))
    os.makedirs(cache_dir, exist_ok=True)
    fname = os.path.basename(urllib.parse.urlparse(path).path) or "checkpoint.pth"
    url_key = hashlib.sha256(path.encode()).hexdigest()[:16]
    dst = os.path.join(cache_dir, f"{url_key}-{fname}")
    if not os.path.exists(dst):
        tmp = dst + ".part"
        urllib.request.urlretrieve(path, tmp)
        os.replace(tmp, dst)
    if sha256 is not None:
        h = hashlib.sha256()
        with open(dst, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        if h.hexdigest() != sha256:
            os.remove(dst)
            raise ValueError(f"checkpoint {path}: sha256 mismatch (got {h.hexdigest()}, want "
                             f"{sha256}); cached copy removed")
    return dst


def load_torch_state_dict(path: str, sha256: str | None = None) -> Dict[str, np.ndarray]:
    """Load a torch .pth checkpoint (local path or URL) into
    {key: np.ndarray} on the host (the ``state_dict`` or ``model`` entry
    when the file nests one).

    ``weights_only=True`` first (no code runs while unpickling: most MAE
    checkpoints are plain tensor dicts); a legacy pickle that needs full
    unpickling falls back with a warning.
    """
    path = resolve_checkpoint_path(path, sha256=sha256)
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # legacy pickle (e.g. argparse.Namespace in meta)
        warnings.warn(f"{path}: not loadable with weights_only=True; falling back to full "
                      "unpickling — only load checkpoints you trust", stacklevel=2)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model"):
            if key in ckpt:
                ckpt = ckpt[key]
                break
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items() if hasattr(v, "detach")}


def mae_to_vit_params(state: Mapping[str, np.ndarray], params: Mapping[str, torch.Tensor],
                      depth: int = 12) -> Dict[str, torch.Tensor]:
    """Graft MAE encoder weights onto a ``VisionTransformerDet`` state dict.

    Args:
        state: torch state_dict arrays (encoder naming: ``patch_embed.proj``,
            ``cls_token``, ``pos_embed``, ``blocks.N.{norm1,attn,norm2,mlp}``).
        params: the backbone's ``state_dict()`` (not modified).

    Returns:
        a new state dict with the same keys: grafted tensors replaced (in
        each target's dtype and device), every other one a copy.
    """
    out = {k: v.detach().clone() for k, v in params.items()}

    def put(flax_path: tuple, value: np.ndarray) -> None:
        key, arr = _leaf(flax_path, value)
        tgt = out[key]
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"mae_to_vit_params: {key} is {tuple(tgt.shape)}, the checkpoint "
                             f"gives {tuple(arr.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(tgt)

    def linear(src: str, dst: tuple) -> None:
        if f"{src}.weight" in state:
            put(dst + ("kernel",), state[f"{src}.weight"].T)
        if f"{src}.bias" in state:
            put(dst + ("bias",), state[f"{src}.bias"])

    def layernorm(src: str, dst: tuple) -> None:
        if f"{src}.weight" in state:
            put(dst + ("scale",), state[f"{src}.weight"])
        if f"{src}.bias" in state:
            put(dst + ("bias",), state[f"{src}.bias"])

    if "patch_embed.proj.weight" in state:  # (D, 3, k, k) -> the flax (k, k, 3, D)
        put(("patch_embed", "proj", "kernel"), state["patch_embed.proj.weight"].transpose(2, 3, 1, 0))
        put(("patch_embed", "proj", "bias"), state["patch_embed.proj.bias"])
    if "cls_token" in state:
        put(("cls_token",), state["cls_token"])
    if "pos_embed" in state and "pos_embed" in out:
        pe = np.asarray(state["pos_embed"], np.float32)  # (1, N+1, D)
        if pe.shape != tuple(out["pos_embed"].shape):
            pe = _resize_pos_embed(pe, tuple(out["pos_embed"].shape))
        put(("pos_embed",), pe)
    for i in range(depth):
        src, dst = f"blocks.{i}", (f"blocks_{i}",)
        if f"{src}.norm1.weight" not in state:
            continue
        layernorm(f"{src}.norm1", dst + ("norm1",))
        layernorm(f"{src}.norm2", dst + ("norm2",))
        linear(f"{src}.attn.qkv", dst + ("attn", "qkv"))
        linear(f"{src}.attn.proj", dst + ("attn", "proj"))
        linear(f"{src}.mlp.fc1", dst + ("mlp", "fc1"))
        linear(f"{src}.mlp.fc2", dst + ("mlp", "fc2"))
    return out


def _resize_pos_embed(pe: np.ndarray, tgt_shape) -> np.ndarray:
    """Bicubic-resize a (1, N+1, D) pos embed to a new square grid, as the
    backbone's forward resizes it (A = -0.75, half-pixel sampling)."""
    side = int(round(float(np.sqrt(tgt_shape[1] - 1))))
    res = interpolate_pos_embed(torch.from_numpy(pe), side, side, num_prefix=1)
    return res.numpy().astype(np.float32)


def mae_to_decoder_params(state: Mapping[str, np.ndarray], params: Mapping[str, torch.Tensor],
                          depth: int = 4) -> Dict[str, torch.Tensor]:
    """Graft MAE decoder weights onto a decoder head's state dict.

    Args:
        state: torch state_dict arrays (``decoder_embed``, ``norm``,
            ``decoder_blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``).
        params: the head's ``state_dict()`` (not modified).

    Returns:
        a new state dict with the same keys: each of those tensors that both
        hold replaced (in the target's dtype and device), every other one a
        copy.
    """
    out = {k: v.detach().clone() for k, v in params.items()}
    mods = ["decoder_embed", "norm"] + [
        f"decoder_blocks.{i}.{m}" for i in range(depth)
        for m in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")]
    for mod in mods:
        if f"{mod}.weight" not in state or f"{mod}.weight" not in out:
            continue
        for leaf in ("weight", "bias"):
            key = f"{mod}.{leaf}"
            if key not in state:
                continue
            arr = np.asarray(state[key], np.float32)
            if tuple(arr.shape) != tuple(out[key].shape):
                raise ValueError(f"mae_to_decoder_params: {key} is {tuple(out[key].shape)}, the "
                                 f"checkpoint gives {tuple(arr.shape)}")
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(out[key])
    return out


_RESNET_LEAVES = ("weight", "bias", "running_mean", "running_var")


def torchvision_resnet_params(state: Mapping[str, np.ndarray],
                              params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Graft a torchvision ResNet ``state_dict`` onto a ``ResNet`` state dict.

    Args:
        state: torch state_dict arrays (``conv1``, ``bn1``,
            ``layer{s}.{b}.{conv,bn}{1,2,3}``, ``layer{s}.0.downsample.{0,1}``,
            ``fc``).
        params: the backbone's ``state_dict()`` (not modified).

    Returns:
        a new state dict with the same keys: every conv weight and BN
        vector the checkpoint holds replaced (in each target's dtype and
        device), every other one a copy.
    """
    out = {k: v.detach().clone() for k, v in params.items()}
    for key, tgt in out.items():
        if key.rsplit(".", 1)[-1] not in _RESNET_LEAVES or key not in state:
            continue
        arr = np.asarray(state[key], np.float32)
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"torchvision_resnet_params: {key} is {tuple(tgt.shape)}, the "
                             f"checkpoint gives {tuple(arr.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(tgt)
    return out
