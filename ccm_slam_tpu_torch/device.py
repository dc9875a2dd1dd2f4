"""Device selection: the card by default, the CPU only on request."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda:0`` when ``device`` is None; raises when no card is present.

    The CPU is used only when the caller asks for it (``device="cpu"``), as
    the tests do -- there is no silent fallback.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
