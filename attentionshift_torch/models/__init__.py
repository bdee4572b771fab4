"""ViT and Swin backbones, FPN, RPN, RoI heads and the detector; the
memory bank; the refinement stage's ResNet (``models.resnet``) and Mask
R-CNN (``models.mask_rcnn``)."""

from .detector import AttnShiftDetector, TestOutputs
from .heads import MILHead
from .layers import Attention, Block, Mlp, PatchEmbed
from .memory_bank import MemoryBank, align_loss, bank_append, init_bank, retrieve_similar
from .swin import SwinTransformer
from .vit import VisionTransformerDet

__all__ = ["AttnShiftDetector", "TestOutputs", "MILHead", "Attention", "Block", "Mlp", "PatchEmbed",
           "VisionTransformerDet", "MemoryBank", "align_loss", "bank_append", "init_bank",
           "retrieve_similar", "SwinTransformer"]
