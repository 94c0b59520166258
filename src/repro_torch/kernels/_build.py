"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``_build/lib<name>-<hash>.so`` (the hash covers the source, the shared
headers ``csrc/*.cuh`` and the flags, so an edited source never loads a
stale library), with nvcc's output beside it in ``lib<name>-<hash>.log``.
Compilation happens at first use, or all at once through :func:`build`
(one nvcc process per source, started together). The libraries expose a
plain C interface: every pointer and the stream are ``c_void_p``, and each
entry point returns ``cudaGetLastError()`` after its launch, which
:func:`check` turns into an exception. A kernel writes through raw
pointers, outside autograd, so every wrapper first calls
:func:`refuse_autograd`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "check",
           "refuse_autograd"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("sa_combine", "flash_attention", "rwkv6_wkv", "graph_gate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C signatures of each library's entry points
SIGNATURES = {
    "sa_combine": {
        # ..., n, P, dtype, blocks, threads, vectorized, lanes, stream
        "sa_update_launch": (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                             _P),
        "sa_fused_launch": (_P, _P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I,
                            _I, _P),
    },
    "flash_attention": {
        # q, k, v, out, B, H, K, S, T, hd, instance, causal, scale, dtype,
        # stream
        "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _F, _I, _P),
    },
    "rwkv6_wkv": {
        "rwkv6_wkv_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _P),
    },
    "graph_gate": {
        # capture stream, pred, body stream; body stream
        "gate_if_begin": (_P, _P, _P),
        "gate_if_end": (_P,),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from "
        "src/repro_torch/kernels/csrc at first use and need the CUDA "
        "toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _log_path(lib: Path) -> Path:
    return lib.with_suffix(".log")


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together. Returns, per source: seconds, the
    library path, whether an existing library was reused, and nvcc's
    output lines (with -Xptxas -v: registers and spills per kernel), kept
    from the build that made a reused library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log, jobs = {}, {}
    for name in names:
        out = lib_path(name)
        if out.exists() and _log_path(out).exists():
            log[name] = {"seconds": 0.0, "path": str(out), "reused": True,
                         "ptxas": _log_path(out).read_text().splitlines()}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in jobs.items():
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{stdout}\n{stderr}")
        ptxas = [ln.strip() for ln in (stdout + stderr).splitlines()
                 if ln.strip()]
        _log_path(tmp).write_text("\n".join(ptxas) + "\n")
        # atomic: a concurrent loader sees all or nothing; the library goes
        # last, so a library on disk always has its log beside it
        os.replace(_log_path(tmp), _log_path(out))
        os.replace(tmp, out)
        log[name] = {"seconds": seconds, "path": str(out), "reused": False,
                     "ptxas": ptxas}
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = lib_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what}: kernel launch failed with CUDA error {rc} "
            "(cudaGetLastError after the launch)")


def refuse_autograd(what: str, *tensors) -> None:
    """Raise when autograd would record a call of kernel ``what``: grad
    mode on and an input that requires grad. Its output would be cut off
    from the graph, leaving the inputs without a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the kernel has no "
            "backward (nor has its TPU kernel in the reference). A model "
            "that trains takes use_flash=False (RWKV6: use_kernel=False), "
            "the plain PyTorch path; sample under torch.no_grad() or with "
            "detached parameters.")
