"""Architecture configs of the port (one module per arch).

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests). ``get_config(name)`` /
``get_smoke(name)`` / ``ARCHS`` are the public API, in the reference's
order. The port carries the dense LMs (granite-34b, starcoder2-15b,
starcoder2-3b, gemma-7b, musicgen-large), RWKV6-3B (an LM, or a denoiser
backbone with ``denoiser_latent`` set) and the paper's two denoiser archs;
the MoE, MLA, M-RoPE and hybrid archs come with later slices.
"""

from __future__ import annotations

import importlib

__all__ = ["ARCHS", "get_config", "get_smoke"]

ARCHS = (
    "granite-34b",
    "starcoder2-15b",
    "starcoder2-3b",
    "gemma-7b",
    "musicgen-large",
    "rwkv6-3b",
    # the paper's own denoiser architectures
    "dit-xl-2",
    "dit-s",
)

_MODULES = {name: name.replace("-", "_") for name in ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; the PyTorch port has {sorted(_MODULES)} "
            "(the rest of the LM zoo, its MoE, MLA, M-RoPE and hybrid "
            "archs, comes with later slices)")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str):
    return _mod(name).full()


def get_smoke(name: str):
    return _mod(name).smoke()
