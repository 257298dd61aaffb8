"""Where the port's entry points run: CUDA unless the caller asks for the
CPU, and never the CPU by default when no card is present."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist — entry points
    never drift to the CPU on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return dev
