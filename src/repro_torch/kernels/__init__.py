"""Kernels of the port: the generated Triton stitched kernel
(:mod:`.stitched`), the plain-PyTorch oracles (:mod:`.ref`) and the
model-facing wrappers (:mod:`.ops`)."""
