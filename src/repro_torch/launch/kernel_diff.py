"""Compare the port's combine and flash kernels of two checkouts on one card.

    python -m repro_torch.launch.kernel_diff OLD_ROOT [NEW_ROOT]

Compiles ``src/repro_torch/kernels/csrc/sa_combine.cu`` and
``flash_attention.cu`` of both roots (NEW_ROOT: this checkout) with the
build's nvcc flags, one nvcc per source and root, all started together.
Prints one JSON object:

- per kernel instance of either build: ptxas registers and spill bytes,
  old and new, and whether its SASS (``cuobjdump -sass``, addresses and
  encodings dropped) is the same in both;
- flash at the shapes of PERF.md's table (f32) and the combines at the
  main path's P 3 (n = 32,768, f32), timed through each root's library in
  turns (old, new, new, old) on the same inputs: the median of 50 replays
  of a CUDA graph of 20 calls, beside the card's name and power limit.

Needs a CUDA card, nvcc and cuobjdump.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCES = ("sa_combine", "flash_attention")
#: flash shapes (B, H, K, S, T, hd, causal): DiT-XL/2, starcoder2-3b's
#: forward, gemma-7b's head dim, zamba2-7b's forward and its denoiser
FLASH_SHAPES = {"dit": (8, 16, 16, 256, 256, 72, False),
                "lm": (8, 24, 2, 512, 512, 128, True),
                "hd256": (8, 16, 16, 512, 512, 256, True),
                "hd224": (8, 32, 32, 512, 512, 224, True),
                "hd224_denoiser": (8, 32, 32, 256, 256, 224, True)}
COMBINE_N, COMBINE_P = 32768, 3

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _tool(name: str) -> str:
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found")


def _csrc(root: str) -> Path:
    return Path(root) / "src" / "repro_torch" / "kernels" / "csrc"


def build(roots: dict, work: Path) -> dict:
    """{(tag, source): (library path, ptxas lines)}, compiled in parallel."""
    from ..kernels._build import NVCC_FLAGS
    jobs = {}
    for tag, root in roots.items():
        for name in SOURCES:
            out = work / f"{tag}_{name}.so"
            cmd = [_tool("nvcc"), *NVCC_FLAGS, "-I", str(_csrc(root)), "-o",
                   str(out), str(_csrc(root) / f"{name}.cu")]
            jobs[tag, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    built = {}
    for key, (proc, out) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        built[key] = (out, text.splitlines())
    return built


def kernel_key(mangled: str) -> str:
    """A kernel instance by name, element type and template ints, e.g.
    ``flash_kernel<f32,72>`` (``,padded`` for flash's padded variant):
    the mangled names of two builds differ in the anonymous namespace's
    name (a hash of the source file) and wherever a template parameter or
    an argument was added."""
    m = re.search(r"\d([a-z_]+_kernel)I((?:f|13__nv_bfloat16)*)Li(\d+)E"
                  r"(?:Li(\d+)E)?(?:Lb([01])E)?", mangled)
    if not m:
        return mangled
    params = ["f32" if d == "f" else "bf16"
              for d in re.findall(r"f|13__nv_bfloat16", m.group(2))]
    params += [g for g in m.group(3, 4) if g]
    params += ["padded"] if m.group(5) == "1" else []
    return f"{m.group(1)}<{','.join(params)}>"


def ptxas(lines) -> dict:
    """{mangled kernel: {"registers", "spill_stores", "spill_loads"}}."""
    out, name = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_key(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def sass(lib: Path) -> dict:
    """{mangled kernel: its SASS with addresses and encodings dropped}."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name, body = {}, None, []
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            if name:
                funcs[name] = "\n".join(body)
            name, body = kernel_key(m.group(1)), []
            continue
        if name:
            ln = re.sub(r"/\*[0-9a-fx ]*\*/", "", ln).strip()
            if ln:
                body.append(ln)
    if name:
        funcs[name] = "\n".join(body)
    return funcs


def time_ms(fn, inner: int = 20, samples: int = 50) -> float:
    """Median device ms of one ``fn()``: ``inner`` calls in a CUDA graph,
    replayed ``samples`` times between CUDA events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _flash_call(lib, takes_instance: bool, q, k, v, out, causal: bool):
    """A call of one build's flash entry (the new one takes the instance
    after the head dim) on these tensors; raises on its error."""
    import torch
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    extra = (hd,) if takes_instance else ()
    fn = lib.flash_attention_launch
    fn.argtypes = [_P] * 4 + [_I] * (6 + len(extra) + 1) + [_F, _I, _P]
    fn.restype = _I

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                H, K, S, T, hd, *extra, int(causal), 1.0 / math.sqrt(hd), 0,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash launch failed: {rc}")
    return call


def _combine_call(lib, entry: str, x, buf, xi, coeffs, outs):
    import torch
    from ..kernels import _build, sa_update
    fn = getattr(lib, entry)
    fn.argtypes = _build.SIGNATURES["sa_combine"][entry]
    fn.restype = _I
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    args = sa_update.launch_args(x, buf, xi, coeffs, outs, sms)

    def call():
        rc = fn(*args, 1, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{entry} launch failed: {rc}")
    return call


def times(built: dict, roots: dict) -> dict:
    """Each timed call through each root's library, in turns."""
    import torch
    g = torch.Generator("cuda").manual_seed(0)
    rnd = lambda s: torch.randn(s, generator=g, device="cuda")  # noqa: E731
    takes = {tag: "int inst," in (_csrc(root) / "flash_attention.cu")
             .read_text() for tag, root in roots.items()}
    libs = {key: ctypes.CDLL(str(path)) for key, (path, _) in built.items()}
    calls = {}
    for label, (B, H, K, S, T, hd, causal) in FLASH_SHAPES.items():
        q, k, v = rnd((B, H, S, hd)), rnd((B, K, T, hd)), rnd((B, K, T, hd))
        out = torch.empty_like(q)
        calls[f"flash_{label}"] = {tag: _flash_call(
            libs[tag, "flash_attention"], takes[tag], q, k, v, out, causal)
            for tag in roots}
    x, xi = rnd(COMBINE_N), rnd(COMBINE_N)
    buf = rnd((COMBINE_P, COMBINE_N))
    c = torch.tensor([[0.9, 0.1] + [0.3 / (j + 1) for j in range(COMBINE_P)],
                      [0.9, 0.1] + [-0.2 * (j + 1) for j in range(COMBINE_P)]],
                     device="cuda")
    o1, o2 = torch.empty_like(x), torch.empty_like(x)
    calls["sa_update_p3"] = {tag: _combine_call(
        libs[tag, "sa_combine"], "sa_update_launch", x, buf, xi,
        c[0].contiguous(), (o1,)) for tag in roots}
    calls["sa_fused_p3"] = {tag: _combine_call(
        libs[tag, "sa_combine"], "sa_fused_launch", x, buf, xi, c, (o1, o2))
        for tag in roots}
    out = {}
    for label, by_tag in calls.items():
        runs = {tag: [] for tag in roots}
        for tag in ("old", "new", "new", "old"):
            runs[tag].append(time_ms(by_tag[tag]))
        out[label] = runs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_root")
    ap.add_argument("new_root", nargs="?", default=str(
        Path(__file__).resolve().parents[3]))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_diff: no CUDA card", file=sys.stderr)
        return 2
    roots = {"old": args.old_root, "new": args.new_root}
    work = Path(tempfile.mkdtemp(prefix="kernel_diff_"))
    try:
        built = build(roots, work)
        instances = {}
        for name in SOURCES:
            regs = {tag: ptxas(built[tag, name][1]) for tag in roots}
            code = {tag: sass(built[tag, name][0]) for tag in roots}
            for fn in sorted(set(regs["old"]) | set(regs["new"])):
                instances[fn] = {
                    "source": name,
                    **{tag: regs[tag].get(fn) for tag in roots},
                    "same_sass": fn in code["old"] and fn in code["new"]
                    and code["old"][fn] == code["new"][fn]}
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(json.dumps({"card": smi, "roots": roots,
                          "instances": instances,
                          "times_ms": times(built, roots)}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
