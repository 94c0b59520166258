"""Architecture configs of the port (one module per arch).

Each module exposes ``full()`` (the published config), ``smoke()`` (a
reduced same-family config for CPU tests) and ``META`` (an
:class:`ArchMeta`: family, the shape cells that apply, source).
``get_config(name)`` / ``get_smoke(name)`` / ``get_meta(name)`` /
``ARCHS`` / ``SHAPES`` are the public API, in the reference's
order: the reference's whole zoo. The dense LMs (granite-34b,
starcoder2-15b, starcoder2-3b, gemma-7b, musicgen-large), RWKV6-3B (an
LM, or a denoiser backbone with ``denoiser_latent`` set), qwen2-vl-2b
(M-RoPE, embeddings in), the MoE family (deepseek-v3-671b: MLA, a dense
prefix, a shared expert and MTP; dbrx-132b), zamba2-7b (the Mamba2
hybrid; an LM, or a denoiser backbone) and the paper's two denoiser
archs.

Shape cells (the reference's, for the dry run ``launch.dryrun``):
    train_4k     seq 4096,   global_batch 256   (train step)
    prefill_32k  seq 32768,  global_batch 32    (prefill)
    decode_32k   KV 32768,   global_batch 128   (one new token)
    long_500k    KV 524288,  global_batch 1     (one new token;
                                                 sub-quadratic archs only)
    sample_256 / sample_64   256 / 64 latent tokens, batch 256 (an SA
                             solve at NFE 20 of the denoiser archs)
"""

from __future__ import annotations

import dataclasses
import importlib

__all__ = ["ARCHS", "SHAPES", "ArchMeta", "ShapeCell", "get_config",
           "get_smoke", "get_meta"]


@dataclasses.dataclass(frozen=True)
class ArchMeta:
    name: str
    family: str               # dense | moe | ssm | hybrid | audio | vlm
    shapes: tuple[str, ...]   # applicable cells
    source: str
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "sample"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
    # the paper's own workload: SA-Solver sampling of the DiT denoisers
    # (seq = latent tokens; an NFE-20 P3C3 tau=1 solve, launch/cells.py)
    "sample_256": ShapeCell("sample_256", 256, 256, "sample"),
    "sample_64": ShapeCell("sample_64", 64, 256, "sample"),
}

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


def get_meta(name: str) -> ArchMeta:
    return _mod(name).META
