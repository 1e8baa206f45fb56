"""repro_torch — the PyTorch / CUDA port of the FusionStitching system.

Tracing (``torch.fx``) turns a PyTorch function into StitchIR, the planner
(pattern generation, cost model, ILP) picks fusion patterns, the tuner
emits each chosen pattern as one generated Triton stitched kernel, and
:func:`repro_torch.exec.stitch` runs the result.  Serving
(:mod:`repro_torch.serve`) is built on that call.
"""
