"""Architecture configs of the port (one module per arch).

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests). ``get_config(name)`` /
``get_smoke(name)`` / ``ARCHS`` are the public API. The port carries the
paper's two denoiser archs, RWKV6-3B (an LM, or a denoiser backbone with
``denoiser_latent`` set) and the dense LM starcoder2-3b; the rest of the
LM zoo comes with later slices.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "get_smoke"]

ARCHS = ("dit-xl-2", "dit-s", "rwkv6-3b", "starcoder2-3b")

_MODULES = {name: name.replace("-", "_") for name in ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; the PyTorch port has {sorted(_MODULES)} "
            "(the rest of the LM zoo comes with later slices)")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str):
    return _mod(name).full()


def get_smoke(name: str):
    return _mod(name).smoke()
