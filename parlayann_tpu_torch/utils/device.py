"""The device an entry point builds on.

Entry points run on the card unless the caller asks for another device:
``device=None`` means the current CUDA device, and without one they raise
instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")``; anything else as given.
    Raises RuntimeError when ``None`` is given and no CUDA device exists."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
