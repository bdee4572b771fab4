"""ViT, Swin and MAE-encoder backbones, FPN, RPN, RoI heads and the
detector; the memory bank; the supervision-point generator and the
deformable attention; the self-supervised heads and the MIM ViT; the
refinement stage's ResNet (``models.resnet``) and Mask R-CNN
(``models.mask_rcnn``)."""

from .deformable_attention import DeformableConvAttention
from .detector import AttnShiftDetector, TestOutputs
from .heads import MILHead
from .layers import Attention, Block, Mlp, PatchEmbed
from .mae_encoder import MAEVisionTransformer, get_sinusoid_encoding_table
from .memory_bank import MemoryBank, align_loss, bank_append, init_bank, retrieve_similar
from .point_generator import SupervisionPointGenerator, convex_hull_mask
from .ssl import DINOHead, IBOTHead, MIMViT
from .swin import SwinTransformer
from .vit import VisionTransformerDet

__all__ = ["AttnShiftDetector", "TestOutputs", "MILHead", "Attention", "Block", "Mlp", "PatchEmbed",
           "VisionTransformerDet", "MemoryBank", "align_loss", "bank_append", "init_bank",
           "retrieve_similar", "SwinTransformer", "DeformableConvAttention",
           "MAEVisionTransformer", "get_sinusoid_encoding_table", "SupervisionPointGenerator",
           "convex_hull_mask", "DINOHead", "IBOTHead", "MIMViT"]
