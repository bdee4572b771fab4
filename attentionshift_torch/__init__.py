"""attentionshift_torch — the PyTorch/CUDA port of ``attentionshift_tpu``.

The JAX package beside this one stays the reference; this package
computes the same functions with PyTorch for the plain tensor code and
hand-written CUDA kernels (``csrc/``, built for ``sm_90a``) where the
JAX package had Pallas kernels. The layout mirrors the JAX package:

- ``config``   python-file configs with ``_base_`` inheritance
- ``convert``  flax variables -> torch state dict
- ``ops``      resize, masks, roi_align, NMS, top-k, point sampling, and
               the kernel wrappers (attention forward and backward,
               connected components, mean-shift fixpoint)
- ``core``     boxes, anchors, losses, assigners and samplers, linear
               sum assignment
- ``pseudo``   the pseudo-label engine (rollout -> CAM -> boxes ->
               refinement -> mean-shift semantic centers)
- ``models``   ViT backbone, FPN, RPN, the MIL, box and mask heads, and
               ``AttnShiftDetector`` (pseudo labels and the train forward);
               the refinement stage's ResNet and ``MaskRCNN``
- ``train``    layer-decay AdamW and the refinement stage's SGD, the
               train state and the train steps

Importing the package imports nothing heavy and builds no kernel.
"""

__version__ = "0.1.0"
