"""Sample-quality metric on analytic targets: sliced Wasserstein-2 between
a sample set and target samples (for mixtures, where moments are not
sufficient)."""

from __future__ import annotations

import torch

__all__ = ["sliced_w2"]


def sliced_w2(x: torch.Tensor, y: torch.Tensor, generator: torch.Generator,
              n_proj: int = 64) -> float:
    """Sliced W2^2 between sample sets x [N, d] and y [N, d]; the
    projection directions are drawn on ``generator``."""
    if x.shape != y.shape:
        raise ValueError(f"use equal sample counts: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    d = x.shape[-1]
    dirs = torch.randn((n_proj, d), generator=generator,
                       device=generator.device)
    dirs = (dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)).to(x.device)
    xp = torch.sort(x.float() @ dirs.T, dim=0).values  # [N, n_proj]
    yp = torch.sort(y.float() @ dirs.T, dim=0).values
    return float(torch.mean((xp - yp) ** 2))
