"""Dispatch for the port's kernels.

``mode="auto"`` (the default): a CPU tensor takes the kernel's plain
PyTorch version; any other tensor goes to the hand-written Hopper kernel,
which launches on a CUDA tensor or raises. There is no fallback from the
kernel to the plain version. ``mode="plain"`` forces the plain version on
any device (tests, and the card-side comparisons in ``chip_smoke.py``).
"""

from __future__ import annotations

from . import flash_attention as _flash
from . import rwkv6_scan as _wkv
from . import sa_fused as _fused
from . import sa_update as _update

__all__ = ["sa_update", "sa_fused_update", "sa_update_lanes",
           "sa_fused_update_lanes", "flash_attention", "wkv",
           "launch_counts", "reset_launch_counts", "add_launches"]

_MODES = ("auto", "plain")
_KERNELS = {"sa_update": _update, "sa_fused": _fused,
            "flash_attention": _flash, "rwkv6_wkv": _wkv}


def _plain(mode: str, t) -> bool:
    if mode not in _MODES:
        raise ValueError(f"mode={mode!r}; expected one of {_MODES}")
    return mode == "plain" or t.device.type == "cpu"


def sa_update(x, buf, xi, coeffs, *, mode: str = "auto"):
    """coeffs [P+2] packed as (decay, noise, b_0..b_{P-1})."""
    if _plain(mode, x):
        return _update.sa_update_plain(x, buf, xi, coeffs)
    return _update.sa_update(x, buf, xi, coeffs)


def sa_fused_update(x, buf, xi, coeffs, *, mode: str = "auto"):
    """coeffs [2, P+2] (row 0 predictor, row 1 corrector) ->
    ``(x_pred, corr_base)``."""
    if _plain(mode, x):
        return _fused.sa_fused_update_plain(x, buf, xi, coeffs)
    return _fused.sa_fused_update(x, buf, xi, coeffs)


def sa_update_lanes(x, buf, xi, coeffs, *, mode: str = "auto"):
    """Lane-batched ``sa_update``: x [L, *shape], buf [L, P, *shape], coeffs
    [L, P+2]; counted under ``sa_update``."""
    if _plain(mode, x):
        return _update.sa_update_lanes_plain(x, buf, xi, coeffs)
    return _update.sa_update_lanes(x, buf, xi, coeffs)


def sa_fused_update_lanes(x, buf, xi, coeffs, *, mode: str = "auto"):
    """Lane-batched ``sa_fused_update``: coeffs [L, 2, P+2] ->
    ``(x_pred, corr_base)``, each [L, *shape]; counted under
    ``sa_fused``."""
    if _plain(mode, x):
        return _fused.sa_fused_update_lanes_plain(x, buf, xi, coeffs)
    return _fused.sa_fused_update_lanes(x, buf, xi, coeffs)


def flash_attention(q, k, v, *, causal: bool = True, mode: str = "auto"):
    if _plain(mode, q):
        return _flash.flash_attention_plain(q, k, v, causal=causal)
    return _flash.flash_attention(q, k, v, causal=causal)


def wkv(r, k, v, logw, u, S0, *, chunk: int = 64, mode: str = "auto"):
    """Chunked RWKV6 WKV -> ``(y, S_T)``, both float32; raises unless
    ``chunk`` divides T."""
    if _plain(mode, r):
        return _wkv.rwkv6_wkv_plain(r, k, v, logw, u, S0, chunk=chunk)
    return _wkv.rwkv6_wkv(r, k, v, logw, u, S0, chunk=chunk)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the wrappers' counts: a
    CUDA graph replay launches its captured kernels without running the
    wrappers, so the replay adds the launches its capture recorded."""
    for name, n in counts.items():
        _KERNELS[name].launches += n
