"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU; with no
card and no explicit CPU request they raise instead of quietly running
somewhere else.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    d = torch.device(device if device is not None else "cuda")
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return d
