"""Low-level ops: resize, masks, roi_align and the kernel wrappers.

Submodules are imported where they are used; importing this package
builds nothing.
"""
