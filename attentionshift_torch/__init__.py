"""attentionshift_torch — the PyTorch/CUDA port of ``attentionshift_tpu``.

The JAX package beside this one stays the reference; this package
computes the same functions with PyTorch for the plain tensor code and
hand-written CUDA kernels (``csrc/``, built for ``sm_90a``) where the
JAX package had Pallas kernels. The layout mirrors the JAX package:

- ``config``   python-file configs with ``_base_`` inheritance
- ``convert``  flax variables -> torch state dict
- ``ops``      resize, masks, roi_align, and the kernel wrappers
               (attention, connected components, mean-shift fixpoint)
- ``core``     linear sum assignment and the Hungarian point assigner
- ``pseudo``   the pseudo-label engine (rollout -> CAM -> boxes ->
               refinement -> mean-shift semantic centers)
- ``models``   ViT backbone, MIL head, and ``AttnShiftDetector``

Importing the package imports nothing heavy and builds no kernel.
"""

__version__ = "0.1.0"
