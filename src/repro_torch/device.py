"""Device selection for the port's entry points.

Entry points (``launch.sample``, the model builders, ``chip_smoke.py``)
run on the card unless the caller asks for the CPU; with no card they
raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when a CUDA device is
    asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is False. The port "
            "runs on an NVIDIA GPU by default; pass device='cpu' "
            "(--device cpu) to run on the CPU")
    return dev
