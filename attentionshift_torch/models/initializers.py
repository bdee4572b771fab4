"""Seeded draws of the JAX package's initialisers, parameter by parameter.

The JAX modules take flax's defaults unless they name another rule:

- every Dense and conv kernel ``lecun_normal``: a normal truncated at two
  standard deviations and rescaled to std 1/sqrt(fan_in), fan_in the input
  axis of a Dense kernel and kh * kw * cin of a conv kernel;
- biases zeros, norm scales ones (BatchNorm's running mean and variance
  zeros and ones);
- tokens and position tables as the module names them: ``truncated_normal(
  0.02)`` (cut at +-0.04, no rescale: std 0.0176), or zeros.

``flax_init`` draws those for each entry of a port module's state dict,
finding the fans from the owning layer's type and the port's weight
layout (``Dense``: (out, in); ``Conv3x3Matmul``: (3, 3, cin, cout);
``Deconv2x2Matmul`` and ``ConvTranspose2d``: (cin, cout, kh, kw);
``Conv2d``: (cout, cin / groups, kh, kw)). Draws come from one
``torch.Generator`` seeded with ``seed``, in state-dict order: torch
cannot replay JAX's stream, so the two packages' inits agree in
distribution, not value.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn as nn

from .layers import Conv3x3Matmul, Deconv2x2Matmul

__all__ = ["TRUNC_STD", "LECUN", "XAVIER", "flax_init", "fans", "lecun_normal", "normal",
           "normal_rule", "truncated_normal", "xavier_uniform"]

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling divides by it)
TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    """flax ``truncated_normal(std)``: N(0, std^2) cut at +-2 std."""
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


def lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: truncated at 2 sigma, std 1/sqrt(fan_in)."""
    return truncated_normal(shape, fan_in ** -0.5 / TRUNC_STD, gen)


def xavier_uniform(shape, fan_in: int, fan_out: int, gen: torch.Generator) -> torch.Tensor:
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def normal(shape, std: float, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


def fans(layer: nn.Module, w: torch.Tensor) -> tuple[int, int]:
    """(fan_in, fan_out) of ``layer``'s weight ``w`` in the port's layout."""
    if isinstance(layer, Conv3x3Matmul):
        return 9 * w.shape[2], 9 * w.shape[3]
    if isinstance(layer, (Deconv2x2Matmul, nn.ConvTranspose2d)):
        taps = w.shape[2] * w.shape[3]
        return taps * w.shape[0], taps * w.shape[1]
    if isinstance(layer, nn.Conv2d):
        taps = w.shape[2] * w.shape[3]
        return taps * w.shape[1], taps * w.shape[0]
    if isinstance(layer, nn.Linear):
        return w.shape[1], w.shape[0]
    raise TypeError(f"flax_init: no fan rule for {type(layer).__name__}")


# a kernel rule: (shape, fan_in, fan_out, generator) -> tensor
KernelRule = Callable[[tuple, int, int, torch.Generator], torch.Tensor]
LECUN: KernelRule = lambda shape, fi, fo, gen: lecun_normal(shape, fi, gen)
XAVIER: KernelRule = lambda shape, fi, fo, gen: xavier_uniform(shape, fi, fo, gen)


def normal_rule(std: float) -> KernelRule:
    return lambda shape, fi, fo, gen: normal(shape, std, gen)


def flax_init(module: nn.Module, seed: int, tables: Mapping[str, float | None],
              kernel_rules: Mapping[str, KernelRule] | None = None,
              keep: tuple[str, ...] = ()) -> nn.Module:
    """Draw every entry of ``module.state_dict()`` by the JAX module's rule.

    ``tables``: leaf name of a directly held tensor (a token, a position
    table) -> the std of its ``truncated_normal``, or None for zeros.
    ``kernel_rules``: state-dict prefix -> the rule of the kernels below it
    (the longest matching prefix wins); other kernels take ``lecun_normal``.
    ``keep``: leaf names whose built value is the JAX module's constant
    init (a LayerScale's ``init_values``). An entry that no rule covers
    raises.
    """
    rules = sorted((kernel_rules or {}).items(), key=lambda kv: -len(kv[0]))
    layers = dict(module.named_modules())
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            owner, _, leaf = name.rpartition(".")
            if leaf in keep:
                continue
            if leaf in ("bias", "running_mean"):
                val = torch.zeros(t.shape)
            elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
                val = torch.ones(t.shape)
            elif leaf in tables:
                std = tables[leaf]
                val = torch.zeros(t.shape) if std is None else truncated_normal(t.shape, std, gen)
            elif leaf == "weight":
                fan_in, fan_out = fans(layers[owner], t)
                rule = next((r for p, r in rules if name.startswith(p)), LECUN)
                val = rule(tuple(t.shape), fan_in, fan_out, gen)
            else:
                raise KeyError(f"flax_init: no rule for {name}")
            t.copy_(val)
    return module
