"""Sample-quality metrics used as FID stand-ins on analytic targets.

- gaussian_w2: exact 2-Wasserstein between empirical moments and a diagonal
  Gaussian target (closed form): the FID formula *is* a W2 between
  Gaussians, so this is the honest analogue.
- sliced_w2_stat / sliced_w2: sliced Wasserstein-2 between a sample set and
  target samples (for mixtures, where moments are not sufficient).
- energy_distance: E-statistics distance, unbiased, projection-free.
- mean_var_error: the largest per-dimension mean and variance errors.
"""

from __future__ import annotations

import torch

__all__ = ["gaussian_w2", "sliced_w2", "sliced_w2_stat", "energy_distance",
           "mean_var_error"]


def gaussian_w2(samples: torch.Tensor, mean, cov_diag) -> float:
    """W2^2( N(m_hat, diag(v_hat)), N(mean, diag(cov_diag)) ) with empirical
    m_hat/v_hat (population variance) from samples [N, d]."""
    m_hat = torch.mean(samples, dim=0)
    v_hat = torch.var(samples, dim=0, correction=0)
    mean = torch.as_tensor(mean, dtype=samples.dtype, device=samples.device)
    cov = torch.as_tensor(cov_diag, dtype=samples.dtype, device=samples.device)
    w2 = torch.sum((m_hat - mean) ** 2) + torch.sum(
        (torch.sqrt(v_hat) - torch.sqrt(cov)) ** 2)
    return float(w2)


def sliced_w2_stat(x: torch.Tensor, y: torch.Tensor,
                   dirs: torch.Tensor) -> torch.Tensor:
    """Sliced W2^2 between sample sets x [N, d] and y [N, d] as a 0-d
    float32 tensor on their device (no host read, so the autotuner scores
    a whole chunk of candidates before one read-back). ``dirs`` [n_proj,
    d] are the raw projection directions (unit-normal draws), normalized
    here."""
    if x.shape != y.shape:
        raise ValueError(f"use equal sample counts: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    dirs = dirs.to(device=x.device, dtype=torch.float32)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    xp = torch.sort(x.float() @ dirs.T, dim=0).values  # [N, n_proj]
    yp = torch.sort(y.float() @ dirs.T, dim=0).values
    return torch.mean((xp - yp) ** 2)


def sliced_w2(x: torch.Tensor, y: torch.Tensor, generator: torch.Generator,
              n_proj: int = 64) -> float:
    """Sliced W2^2 between sample sets x [N, d] and y [N, d]; the
    projection directions are drawn on ``generator``."""
    dirs = torch.randn((n_proj, x.shape[-1]), generator=generator,
                       device=generator.device)
    return float(sliced_w2_stat(x, y, dirs))


def energy_distance(x: torch.Tensor, y: torch.Tensor,
                    max_n: int = 2048) -> float:
    """Unbiased energy distance between sample sets (subsampled for O(n^2))."""
    x = x[:max_n]
    y = y[:max_n]

    def pdist_mean(a, b):
        d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, dim=-1)
        return torch.mean(torch.sqrt(d2 + 1e-12))

    return float(2 * pdist_mean(x, y) - pdist_mean(x, x) - pdist_mean(y, y))


def mean_var_error(samples: torch.Tensor, mean, var) -> tuple[float, float]:
    """(max |mean error|, max |variance error|) over the dimensions of
    samples [N, d] (population variance)."""
    mean = torch.as_tensor(mean, dtype=samples.dtype, device=samples.device)
    var = torch.as_tensor(var, dtype=samples.dtype, device=samples.device)
    m = float(torch.max(torch.abs(torch.mean(samples, dim=0) - mean)))
    v = float(torch.max(torch.abs(
        torch.var(samples, dim=0, correction=0) - var)))
    return m, v
