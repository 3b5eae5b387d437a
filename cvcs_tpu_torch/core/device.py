"""Device selection: the port runs on the card unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card (``cuda``); ``"cpu"`` must be asked for.
    Raises when a CUDA device is wanted and none is present — the port
    never continues on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or set "
            "'device: cpu' in the config) to run on the CPU")
    return dev

