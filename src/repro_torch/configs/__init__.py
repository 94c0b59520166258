"""Architecture configs of the port (one module per arch).

Each module exposes ``full()`` (the published config) and ``smoke()`` (a
reduced same-family config for CPU tests). ``get_config(name)`` /
``get_smoke(name)`` / ``ARCHS`` are the public API, in the reference's
order: the reference's whole zoo. The dense LMs (granite-34b,
starcoder2-15b, starcoder2-3b, gemma-7b, musicgen-large), RWKV6-3B (an
LM, or a denoiser backbone with ``denoiser_latent`` set), qwen2-vl-2b
(M-RoPE, embeddings in), the MoE family (deepseek-v3-671b: MLA, a dense
prefix, a shared expert and MTP; dbrx-132b), zamba2-7b (the Mamba2
hybrid; an LM, or a denoiser backbone) and the paper's two denoiser
archs.
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
    "qwen2-vl-2b",
    "deepseek-v3-671b",
    "dbrx-132b",
    "zamba2-7b",
    # the paper's own denoiser architectures
    "dit-xl-2",
    "dit-s",
)

_MODULES = {name: name.replace("-", "_") for name in ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[name]}", __package__)


def get_config(name: str):
    return _mod(name).full()


def get_smoke(name: str):
    return _mod(name).smoke()
