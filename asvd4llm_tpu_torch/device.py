"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless the caller names
    another. Asking for CUDA without a card raises; nothing falls back to
    the CPU quietly.

    Also pins f32 matmuls and convolutions to full f32 (no TF32), as the JAX
    package pins f32 contractions to full precision."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
