"""ViT backbone, FPN, RPN, RoI heads and the detector; the refinement
stage's ResNet (``models.resnet``) and Mask R-CNN (``models.mask_rcnn``)."""

from .detector import AttnShiftDetector, TestOutputs
from .heads import MILHead
from .layers import Attention, Block, Mlp, PatchEmbed
from .vit import VisionTransformerDet

__all__ = ["AttnShiftDetector", "TestOutputs", "MILHead", "Attention", "Block", "Mlp", "PatchEmbed",
           "VisionTransformerDet"]
