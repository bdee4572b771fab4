"""ViT backbone, MIL head and the pseudo-label detector."""

from .detector import AttnShiftDetector
from .heads import MILHead
from .layers import Attention, Block, Mlp, PatchEmbed
from .vit import VisionTransformerDet

__all__ = ["AttnShiftDetector", "MILHead", "Attention", "Block", "Mlp", "PatchEmbed",
           "VisionTransformerDet"]
