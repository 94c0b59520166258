#!/usr/bin/env python3
"""Drive the PyTorch port of SA-Solver on one NVIDIA card and check it.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, times each at the main
path's shape (the combines also over a size sweep, beside the per-launch
floor of the same yardstick), then drives SA-Solver
through the port's public entry points and the kernels over two
full-width backbones: DiT-XL/2 (28 layers, d_model 1152) and the RWKV6-3B
denoiser (32 layers, d_model 2560, 40 heads of 64, d_ff 8960), each on a
latent [8, 256, 16]; step programs and the SEEDS and DPM-Solver++ rules
over DiT-XL/2 (``programs_path``); a class-conditional DiT-XL/2 under
one-call classifier-free guidance (``guided_path``); the compiled
executor's CUDA graphs against its eager solves over DiT-XL/2
(``graph_path``); the serve engine under both schedulers (solve-granular
microbatches and the step protocol's lane-batched ticks, through the
lane-batched combine kernel) over a class-conditional DiT-XL/2, one
(256, 16) latent a request (``serve_path``); the paper's six baseline
samplers over DiT-XL/2 through the compile cache's graphs, under
one-call guidance, under the step scheduler and through the sampling
entry point (``baselines_path``); DeepCache feature caching over DiT-XL/2,
its refresh gated on the device, per lane under ``sample_batched`` and
served by the step scheduler (``feature_cache_path``); the sharded path
over ``torch.distributed`` (``sharded_path``: ``sample_sharded`` and the
sharded engine at one NCCL rank, ``--cfg-shard``'s refusal, and sharded
classifier-free guidance at two gloo ranks sharing the card, started as
``chip_smoke.py --cfg-rank RANK DIR``); training the DiT denoiser
(``train_path``: the checkpointed ``TrainLoop`` at DiT-XL/2 full width,
which launches no kernel, a checkpoint restored bitwise, remat and
resume checks at 4 layers, gradients on the card against the CPU, the
trained model sampled through flash and sa_fused, and
``examples/torch_train_denoiser.py`` on the card); the LM path served
(``lm_path``: starcoder2-3b and RWKV6-3B at full width, batch 8, bf16
stream and cache: starcoder2-3b's forward through causal flash at GQA
12:1, prefill and greedy decode of both, RWKV6's aligned, ragged and
short prefills through the WKV kernel's whole chunks, 4-layer
consistency checks, ``launch.serve.main`` in both modes); training the LM
(``lm_train_path``: starcoder2-3b and RWKV6-3B trained at full width
through ``launch.train``'s step, which launches no kernel, the card's
gradients against the CPU's at 4 layers, the driver's CLI killed and
resumed bit for bit, ``examples/torch_lm_train_resume.py``); the rest of
the dense zoo served (``lm_zoo_path``: starcoder2-15b, granite-34b cut to
the layers the card holds, gemma-7b through flash's head-dim-256
instance, musicgen-large, every flash call held); the MoE family
(``moe_path``: dbrx-132b with f32 weights and deepseek-v3-671b with MLA,
its dense prefix and MTP on bf16 weights, served at published width and
cut depth, dbrx's flash calls held, consistency at 4 / 2 layers with
every routing choice compared, the smoke CLI trained and resumed, and
an SA solve over the MoE denoiser through flash and sa_fused); the
Mamba2/Zamba2 hybrid and M-RoPE (``hybrid_path``: zamba2-7b at published
width and depth served, its shared attention through flash's
head-dim-224 instance, an SA solve over its tame denoiser (15 of the 81
layers) through flash and sa_fused against the plain attention, and
qwen2-vl-2b over a (t, h, w) grid of M-RoPE positions); the distribution
layer (``parallel_path``: two gloo ranks sharing the card, started as
``chip_smoke.py --parallel-rank RANK DIR``, train starcoder2-3b at
published width and 4 layers through ``launch.train``'s step on a
(data=2) mesh against one process, all-reduce its gradients through
``compressed_psum`` against the exact all-reduce, and run DiT-XL/2's 28
blocks as a 2-stage pipeline through flash against one rank; then
``examples/torch_quickstart.py`` and ``examples/torch_serve_diffusion.py``
on the card); the port's
sampling entry point
(``launch.sample.main``) with no kernel flag, which must route DiT-XL/2
and the RWKV6 smoke config through their kernels on the card; and SA,
SEEDS, DPM-Solver++ and the six baselines' solves of the GMM oracle.
Each main path runs with
the launch counts set to 0 just before it and read just after; a solve
replays a CUDA graph of the compile cache after its entry's first call,
and the held comparisons of kernel calls with their plain versions run
eager.
Each phase prints one JSON line; any failed check raises, and the script
then exits non-zero without the success line. The last two lines are the
``kernels`` summary and ``{"ok": true, "device": {"platform": "gpu",
...}}``; the card's name and power limit (as nvidia-smi reports them) come
just before them.

Imports nothing of JAX or of the JAX package. Needs one CUDA card, nvcc
and the repository's ``src/`` next to this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense

REPLACES = {
    "sa_update": "src/repro/kernels/sa_update.py:88",
    "sa_fused": "src/repro/kernels/sa_fused.py:43",
    "flash_attention": "src/repro/kernels/flash_attention.py:40",
    "rwkv6_wkv": "src/repro/kernels/rwkv6_scan.py:30",
}
SOURCES = {
    "sa_update": "src/repro_torch/kernels/csrc/sa_combine.cu",
    "sa_fused": "src/repro_torch/kernels/csrc/sa_combine.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "rwkv6_wkv": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
}
#: the kernels each main path must launch
PATH_KERNELS = {"dit": ("sa_update", "sa_fused", "flash_attention"),
                "serve": ("sa_fused", "flash_attention"),
                "tune": ("sa_fused", "flash_attention"),
                "programs": ("sa_update", "sa_fused", "flash_attention"),
                "guided": ("sa_fused", "flash_attention"),
                "feature_cache": ("sa_fused", "flash_attention"),
                "sharded": ("sa_fused", "flash_attention"),
                "graph": ("sa_update", "sa_fused", "flash_attention"),
                "baselines": ("flash_attention",),
                "sample_edm_heun": ("flash_attention",),
                "sample_dit": ("flash_attention",),
                "sample_rwkv6": ("rwkv6_wkv",),
                "rwkv6": ("rwkv6_wkv", "sa_fused"),
                "train": ("sa_fused", "flash_attention"),
                "lm": ("flash_attention", "rwkv6_wkv"),
                "lm_zoo": ("flash_attention",),
                "moe": ("flash_attention",),
                "sample_moe": ("sa_fused", "flash_attention"),
                "hybrid": ("sa_fused", "flash_attention"),
                "parallel": ("flash_attention",),
                "dryrun": ("flash_attention",)}
TOL = {
    "combine_f32": "|kernel - plain| <= 1e-6 + 1e-6 |plain|",
    "attention_f32": "|kernel - plain| <= 2e-5 max(1, max|plain|)",
    "wkv": "|kernel - plain| <= 2e-5 max(1, max|plain|), for y and S_T "
           "(float32 outputs of float32 or bfloat16 inputs)",
    "bf16": "|kernel - plain| <= 1 bf16 ulp of max(|plain|, max|plain|/256)",
}
# latent of both main paths (DiT-XL/2's 256 tokens of dim 16)
SHAPE = (8, 256, 16)
NFE = 20
GAP_LIMIT = 1e-4
#: whole-solve bar on the bfloat16 residual stream (the reference's bf16 bar)
GAP_LIMIT_BF16 = 1e-2
SW2_LIMIT = 0.05
#: the GMM phase's other families (NFE 20, predictor order 3, no
#: corrector, tau 1, fused), each gated at SW2_LIMIT only where the JAX
#: reference's own CPU solve of the same spec meets it (held by
#: tests/test_torch_families.py); otherwise recorded as information
GMM_FAMILIES = {"dpmpp_multistep": True, "seeds": False}
# the RWKV6-3B denoiser's WKV calls: [B, T, H, hd], chunk
WKV_SHAPE = (8, 256, 40, 64)
WKV_CHUNK = 64
#: the combine sweep's sizes (P = 3): the main path's latent [8, 256, 16],
#: the GMM phase's 65,536 x 2, a ragged n (the scalar path), DiT-XL/2's
#: latent at batch 256, and one whose operands are well past the L2 (the
#: one held to the HBM bound; last, it sizes the copy_ stream)
SWEEP_N = (32768, 131072, 1000003, 1048576, 8388608)
L2_BYTES = 50e6  # H100 SXM
#: one served request: a DiT-XL/2 image latent (256 tokens of dim 16)
REQ_SHAPE = SHAPE[1:]
#: lanes of the step scheduler's running batch (and the lane entries'
#: timing)
SERVE_LANES = 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


# ------------------------------------------------------------ measurement
def time_ms(fn, inner: int = 20, samples: int = 50) -> float:
    """Median device time of one ``fn()`` in ms: ``inner`` calls captured
    in a CUDA graph (so host launch overhead is not timed), the graph
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


def bound(n_bytes: float, n_ops: float,
          peak_ops: float = PEAK_F32_FLOP_PER_S) -> tuple[float, str]:
    """(least ms, what sets it) for moving ``n_bytes`` and doing ``n_ops``
    at ``peak_ops`` operations per second."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(ref):
    """One bf16 ulp of each value; values below 1/256 of the tensor's
    largest magnitude (results of cancellation, where float32 round-off
    alone exceeds their own ulp) get the ulp at that floor."""
    import torch
    a = ref.float().abs()
    a = a.clamp_min(max(float(a.max()) * 2.0 ** -8, 2.0 ** -126))
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare(out, ref, kind: str) -> tuple[float, bool]:
    """(max abs error, within tolerance) of kernel output vs plain. ``kind``
    is "combine", or "attention" / "wkv" (held at the output's scale)."""
    import torch
    err = (out.float() - ref.float()).abs()
    if ref.dtype == torch.bfloat16:
        ok = bool((err <= bf16_ulp(ref)).all())
    elif kind == "combine":
        ok = bool((err <= 1e-6 + 1e-6 * ref.float().abs()).all())
    else:
        ok = float(err.max()) <= 2e-5 * max(1.0, float(ref.float().abs().max()))
    return float(err.max()), ok


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def wkv_bytes_ops(B, T, H, hd, C, in_bytes=4) -> tuple[int, int]:
    """Bytes one WKV call must move and the operations it does: the
    kernel module's own count (``kernels/rwkv6_scan.py::cost``, the one
    the dry run charges)."""
    from repro_torch.kernels import rwkv6_scan
    ops_, n_bytes = rwkv6_scan.cost(B, T, H, hd, C, in_bytes)
    return n_bytes, ops_


def flash_cost(B, H, K, S, T, hd, causal, itemsize):
    """``(flops, bytes)`` of one flash call: the kernel module's own
    count, the one the dry run charges."""
    from repro_torch.kernels import flash_attention
    return flash_attention.cost(B, H, K, S, T, hd, causal, itemsize)


def rel_gap(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


# ---------------------------------------------------------------- phases
def phase_device() -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return {"phase": "device", "ok": True,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi.stdout.strip().splitlines()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32}}


def _ptxas_summary(lines) -> list[str]:
    """One line per kernel instance: name, template types and ints,
    registers, spills."""
    out, name, spill = [], None, ""
    pat = re.compile(r"(sa_update_kernel|sa_fused_kernel|flash_kernel|"
                     r"wkv_kernel)I((?:f|13__nv_bfloat16)*)Li(\d+)E"
                     r"(?:Li(\d+)E)?")
    for ln in lines:
        m = pat.search(ln)
        if "Compiling entry function" in ln and m:
            dts = re.findall(r"f|13__nv_bfloat16", m.group(2))
            params = ["f32" if d == "f" else "bf16" for d in dts]
            params += [g for g in m.group(3, 4) if g]
            name = f"{m.group(1)}<{','.join(params)}>"
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name:
            regs = re.search(r"Used (\d+) registers", ln)
            out.append(f"{name}: {regs.group(1) if regs else '?'} regs; {spill}")
            name, spill = None, ""
    return out


#: the instances whose registers must not spill (DiT-XL/2's attention,
#: gemma-7b's at head dim 256, zamba2-7b's at 224, RWKV6-3B's WKV)
NO_SPILL = (("flash_attention", "flash_kernel<f32,72>"),
            ("flash_attention", "flash_kernel<f32,224>"),
            ("flash_attention", "flash_kernel<bf16,224>"),
            ("flash_attention", "flash_kernel<f32,256>"),
            ("flash_attention", "flash_kernel<bf16,256>"),
            ("rwkv6_wkv", "wkv_kernel<64,64>"))


def phase_build() -> dict:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    log = _build.build()
    wall = time.perf_counter() - t0
    res = {"phase": "build", "ok": True, "wall_s": wall,
           "sources": {n: {"seconds": r["seconds"], "reused": r["reused"],
                           "path": os.path.relpath(r["path"], ROOT),
                           "ptxas": _ptxas_summary(r["ptxas"])}
                       for n, r in log.items()}}
    for source, instance in NO_SPILL:
        lines = [ln for ln in res["sources"][source]["ptxas"]
                 if ln.startswith(instance + ":")]
        require(len(lines) == 1 and "0 bytes spill stores, 0 bytes spill "
                "loads" in lines[0], f"{instance} spills: {lines}")
    # every combine instance: 2 dtypes x P 1..5 x 2 kernels
    combine = res["sources"]["sa_combine"]["ptxas"]
    spills = [ln for ln in combine if "0 bytes spill stores, 0 bytes spill "
              "loads" not in ln]
    require(len(combine) == 20 and not spills,
            f"sa_combine: {len(combine)} instances, spilling: {spills}")
    return res


def _combine_inputs(shape, P, dtype, seed):
    import torch
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda s: torch.randn(s, generator=g, device="cuda").to(dtype)
    x, buf, xi = rnd(shape), rnd((P,) + tuple(shape)), rnd(shape)
    c1 = [0.9, 0.1] + [0.3 / (j + 1) for j in range(P)]
    c2 = [0.9, 0.1] + [-0.2 * (j + 1) for j in range(P)]
    coeffs = torch.tensor([c1, c2], dtype=torch.float32, device="cuda")
    return x, buf, xi, coeffs


def _lane_inputs(L, shape, P, dtype, seed):
    """Operands of one lane-batched combine: x and xi [L, *shape], buf
    [L, P, *shape] and per-lane coefficients [L, 2, P+2] (each lane's
    predictor and corrector rows scaled apart)."""
    import torch
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda s: torch.randn(s, generator=g, device="cuda").to(dtype)
    x, xi = rnd((L,) + tuple(shape)), rnd((L,) + tuple(shape))
    buf = rnd((L, P) + tuple(shape))
    _, _, _, c = _combine_inputs((1,), P, torch.float32, seed)
    lanes = 1.0 + 0.1 * torch.arange(L, device="cuda", dtype=torch.float32)
    return x, buf, xi, (c[None] * lanes[:, None, None]).contiguous()


def _offset_view(t, offset: int):
    """``t``'s values as a contiguous view that starts ``offset`` elements
    into a larger flat tensor (so its data pointer is not 16-byte aligned
    for an odd offset)."""
    if not offset:
        return t
    flat = t.new_empty(t.numel() + offset)
    flat[offset:] = t.reshape(-1)
    return flat[offset:].view(t.shape)


def _combine_fns(name, x, buf, xi, c):
    """(kernel call, plain call, library call, library label, output rows)
    of one combine on these operands; the library yardstick is one
    ``torch.matmul`` of the packed coefficients over the operands stacked
    beforehand as one [P+2, n] tensor (x, xi, buf rows: the packing's
    order), in the operand dtype."""
    import torch
    from repro_torch.kernels import ops
    stacked = torch.cat([x.reshape(1, -1), xi.reshape(1, -1),
                         buf.reshape(buf.shape[0], -1)])
    if name == "sa_update":
        c0 = c[0].contiguous()
        cl = c0.to(x.dtype)
        return (lambda: ops.sa_update(x, buf, xi, c0),
                lambda: ops.sa_update(x, buf, xi, c0, mode="plain"),
                lambda: torch.matmul(cl, stacked),
                "torch.matmul(coeffs [P+2], stacked [P+2, n])", 1)
    cl = c.to(x.dtype)
    return (lambda: ops.sa_fused_update(x, buf, xi, c),
            lambda: ops.sa_fused_update(x, buf, xi, c, mode="plain"),
            lambda: torch.matmul(cl, stacked),
            "torch.matmul(coeffs [2, P+2], stacked [P+2, n])", 2)


def combine_bound(rows: int, n: int, P: int, itemsize: int):
    """((least ms, what sets it), bytes) of one combine: the kernel
    module's own count (``kernels/sa_update.py::cost``: x, xi and P
    history rows read once, ``rows`` outputs written once, the
    coefficients read once; per output row 3 + 2P flops an element)."""
    from repro_torch.kernels import sa_update
    flops, n_bytes = sa_update.cost(n, P, itemsize, rows=rows)
    return bound(n_bytes, flops), n_bytes


def combine_times(timings: dict) -> dict:
    """The combines' times: at the main path's shape (f32, P = 3) beside
    the plain version and the library yardstick (into ``timings``); the
    per-node floor of the same yardstick (a one-element ``zero_()``) and
    two ``copy_`` yardsticks; and the sweep over ``SWEEP_N`` (P = 3, f32
    and bfloat16): ms, byte bound, achieved GB/s and share of the bound."""
    import torch
    z = torch.zeros(1, device="cuda")
    floor_ms = time_ms(lambda: z.zero_())
    n = math.prod(SHAPE)
    # what a read before the write adds to the floor, and the rate of a
    # plain read-write stream past the L2: copy_ of n f32 elements, and of
    # as many bytes as sa_update moves at the sweep's largest n in f32
    src = torch.zeros(n, device="cuda")
    dst = torch.empty_like(src)
    copy_small_ms = time_ms(lambda: dst.copy_(src))
    src = torch.zeros(3 * SWEEP_N[-1], device="cuda")
    dst = torch.empty_like(src)
    copy_big_ms = time_ms(lambda: dst.copy_(src))
    copy_bytes = 2 * src.numel() * 4
    copies = {"n_f32_ms": copy_small_ms, "n": n, "stream_ms": copy_big_ms,
              "stream_bytes": copy_bytes,
              "stream_GB_per_s": copy_bytes / copy_big_ms / 1e6,
              "call": "dst.copy_(src), float32"}
    del src, dst
    x, buf, xi, c = _combine_inputs(SHAPE, 3, torch.float32, seed=11)
    for name in ("sa_update", "sa_fused"):
        fn, plain, lib, label, rows = _combine_fns(name, x, buf, xi, c)
        timings[name] = {"ms": time_ms(fn), "plain_ms": time_ms(plain),
                         "library_ms": time_ms(lib), "library_call": label,
                         "launch_floor_ms": floor_ms,
                         "bound": combine_bound(rows, n, 3, 4)[0],
                         "shape": [3, *SHAPE]}
    sweep = []
    for n in SWEEP_N:
        for dtype in (torch.float32, torch.bfloat16):
            x, buf, xi, c = _combine_inputs((n,), 3, dtype, seed=12)
            for name in ("sa_update", "sa_fused"):
                fn, _, lib, _, rows = _combine_fns(name, x, buf, xi, c)
                (b_ms, by), n_bytes = combine_bound(rows, n, 3,
                                                    x.element_size())
                ms = time_ms(fn)
                sweep.append({"kernel": name, "n": n, "P": 3,
                              "dtype": str(dtype).replace("torch.", ""),
                              "ms": ms, "library_ms": time_ms(lib),
                              "bound_ms": b_ms, "bound_by": by,
                              "bytes": n_bytes, "GB_per_s": n_bytes / ms / 1e6,
                              "share_of_bound": b_ms / ms,
                              "operands_fit_l2": n_bytes < L2_BYTES})
            del x, buf, xi, c
    return {"launch_floor_ms": floor_ms,
            "launch_floor_call": "zero_() of a one-element CUDA tensor",
            "copy_yardsticks": copies, "combine_sweep": sweep,
            "lane_entries": lane_times(floor_ms),
            "lane_entries_tune": lane_times(floor_ms, TUNE_LANES,
                                            TUNE_GMM_SHAPE)}


def lane_times(floor_ms: float, L: int = SERVE_LANES,
               shape=REQ_SHAPE) -> dict:
    """The lane-batched entries at ``L`` lanes of ``shape`` each, P = 3:
    by default the serve path's tick (SERVE_LANES lanes of one (256, 16)
    request, 4,096 f32 elements each), and the GMM autotuner's chunk
    (TUNE_LANES lanes of one (512, 2) point set, 1,024 each). ms beside
    the plain loop, the library yardstick (one ``torch.bmm`` of the
    per-lane coefficients over each lane's operands stacked as
    [L, P+2, n]), the byte bound and the launch floor."""
    import torch
    from repro_torch.kernels import ops
    n, P = math.prod(shape), 3
    x, buf, xi, c = _lane_inputs(L, shape, P, torch.float32, seed=13)
    stacked = torch.cat([x.reshape(L, 1, n), xi.reshape(L, 1, n),
                         buf.reshape(L, P, n)], dim=1)
    c0 = c[:, 0].contiguous()
    fns = {"sa_update_lanes": (
               1, lambda: ops.sa_update_lanes(x, buf, xi, c0),
               lambda: ops.sa_update_lanes(x, buf, xi, c0, mode="plain"),
               lambda: torch.bmm(c0[:, None], stacked)),
           "sa_fused_lanes": (
               2, lambda: ops.sa_fused_update_lanes(x, buf, xi, c),
               lambda: ops.sa_fused_update_lanes(x, buf, xi, c, mode="plain"),
               lambda: torch.bmm(c, stacked))}
    from repro_torch.kernels import sa_update
    out = {}
    for name, (rows, fn, plain, lib) in fns.items():
        flops, n_bytes = sa_update.cost(n, P, 4, rows=rows, lanes=L)
        b_ms, by = bound(n_bytes, flops)
        out[name] = {"ms": time_ms(fn), "plain_ms": time_ms(plain),
                     "library_ms": time_ms(lib),
                     "library_call": f"torch.bmm(coeffs [L, {rows}, P+2], "
                                     "stacked [L, P+2, n])",
                     "bound_ms": b_ms, "bound_by": by, "bytes": n_bytes,
                     "launch_floor_ms": floor_ms, "lanes": L,
                     "n_per_lane": n, "P": P, "dtype": "float32"}
    return out


def _attn_inputs(B, H, K, S, T, hd, dtype, seed):
    import torch
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda s: torch.randn(s, generator=g, device="cuda").to(dtype)
    return rnd((B, H, S, hd)), rnd((B, K, T, hd)), rnd((B, K, T, hd))


def _wkv_inputs(B, T, H, hd, dtype, logw_dtype, seed, decay_shift=0.0,
                floor=-8.0):
    """r/k/v in ``dtype``, logw = clip(-exp(N(0,1) - decay_shift), floor,
    -1e-5) (at the default floor clipped like the model's) in
    ``logw_dtype``, u and a nonzero S0 in float32. At shift 0 a chunk of
    64 tokens forgets the state entering it; at shift 4 (logw about -0.02)
    the state carries across chunks; shift -3 with floor -50 gives decays
    beyond the model's clamp."""
    import torch
    g = torch.Generator("cuda").manual_seed(seed)
    rnd = lambda s: torch.randn(s, generator=g, device="cuda")
    r, k, v = (rnd((B, T, H, hd)).to(dtype) for _ in range(3))
    logw = torch.clamp(-torch.exp(rnd((B, T, H, hd)) - decay_shift), floor,
                       -1e-5)
    return (r, k, v, logw.to(logw_dtype), rnd((H, hd)),
            rnd((B, H, hd, hd)))


def _device_kernels(fn) -> list[str]:
    """Names of the device kernels one ``fn()`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({ev.key for ev in prof.key_averages()
                   if str(getattr(ev, "device_type", "")).endswith("CUDA")})


def phase_kernels(timings: dict) -> dict:
    import torch
    from repro_torch.kernels import ops
    cases = []
    # shapes (offset 0), and the main path's n as views one element into
    # their storage, which the vector path cannot take
    for shape, offset in ((SHAPE, 0), ((1000003,), 0), ((4, 100, 7), 0),
                          ((8388608,), 0), ((math.prod(SHAPE),), 1)):
        for P in (1, 3, 5):
            for dtype in (torch.float32, torch.bfloat16):
                x, buf, xi, c = (_offset_view(t, offset) for t in
                                 _combine_inputs(shape, P, dtype, seed=P))
                e1, ok1 = compare(ops.sa_update(x, buf, xi, c[0]),
                                  ops.sa_update(x, buf, xi, c[0], mode="plain"),
                                  "combine")
                kp, kc = ops.sa_fused_update(x, buf, xi, c)
                pp, pc = ops.sa_fused_update(x, buf, xi, c, mode="plain")
                e2, ok2 = compare(kp, pp, "combine")
                e3, ok3 = compare(kc, pc, "combine")
                torch.cuda.synchronize()
                cases.append({"kernel": "sa_update+sa_fused",
                              "shape": list(shape), "offset": offset, "P": P,
                              "dtype": str(dtype).replace("torch.", ""),
                              "sa_update_err": e1,
                              "sa_fused_err": max(e2, e3),
                              "ok": ok1 and ok2 and ok3})
    attn = [  # (B, H, K, S, T, hd, causal)
        (8, 16, 16, 256, 256, 72, False),   # DiT-XL/2
        (8, 16, 16, 256, 256, 72, True),
        (2, 16, 4, 256, 256, 72, True),     # GQA 4:1
        (2, 4, 4, 257, 257, 72, False),     # ragged
        (2, 4, 4, 257, 257, 72, True),
        (2, 4, 2, 200, 200, 64, True),
        (2, 4, 2, 130, 130, 128, False),
        # every head dim with a kernel instance
        *[(2, 4, 2, 96, 96, hd, True)
          for hd in (16, 32, 64, 72, 80, 96, 128, 224, 256)],
        # the edges of the kernel's 64-key tiles and 128-row query tiles
        *[(2, 4, 4, n, n, 72, causal)
          for n in (1, 63, 64, 65, 127, 128, 129) for causal in (False, True)],
        (2, 8, 2, 129, 129, 72, False),     # GQA 4:1 at a ragged edge
        # head dim 256 (gemma-7b): the edges of its 32-key tiles and 64-row
        # query tiles, GQA 4:1, gemma's heads at a prompt of 512
        *[(2, 4, 4, n, n, 256, causal)
          for n in (1, 31, 32, 33, 63, 64, 65) for causal in (False, True)],
        (2, 8, 2, 129, 129, 256, False),
        (8, 16, 16, 512, 512, 256, True),
        # head dim 224 (zamba2-7b's shared attention): the same edges, GQA
        # 4:1, and zamba2-7b's two shapes (the LM's forward, the denoiser's)
        *[(2, 4, 4, n, n, 224, causal)
          for n in (1, 31, 32, 33, 63, 64, 65) for causal in (False, True)],
        (2, 8, 2, 129, 129, 224, False),
        (8, 32, 32, 512, 512, 224, True),
        (8, 32, 32, 256, 256, 224, True),
    ]
    for (B, H, K, S, T, hd, causal) in attn:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attn_inputs(B, H, K, S, T, hd, dtype, seed=hd + S)
            e, ok = compare(ops.flash_attention(q, k, v, causal=causal),
                            ops.flash_attention(q, k, v, causal=causal,
                                                mode="plain"), "attention")
            torch.cuda.synchronize()
            cases.append({"kernel": "flash_attention",
                          "shape": [B, H, K, S, T, hd], "causal": causal,
                          "dtype": str(dtype).replace("torch.", ""),
                          "err": e, "ok": ok})
    f32, bf16 = torch.float32, torch.bfloat16
    dtype_pairs = ((f32, f32), (bf16, f32), (bf16, bf16))  # r/k/v, logw
    decays = ((0.0, -8.0), (4.0, -8.0), (-3.0, -50.0))     # shift, floor
    # (shape, chunk, seed, dtypes, decays): the two full-length shapes are
    # seeded with hd, the others with hd + T
    wkv_cases = [(shape, WKV_CHUNK, seed, dt, decay)
                 for (shape, seed), dt, decay in itertools.product(
                     ((WKV_SHAPE, 64),                   # RWKV6-3B
                      ((8, 256, 4, 32), 32),             # the smoke config's hd
                      ((8, 64, 40, 64), 128),            # one chunk
                      ((2, 1024, 8, 64), 1088),          # 16 chunks: two groups
                      ((2, 576, 4, 32), 608)),           # 9 chunks: 5 and 4
                     dtype_pairs, decays)]
    # every head dim x chunk instance over 9 chunks (two cluster groups)
    wkv_cases += [((2, 9 * chunk, 3, hd), chunk, hd + 9 * chunk, dt,
                   (0.0, -8.0))
                  for hd in (16, 32, 64) for chunk in (16, 32, 64)
                  for dt in dtype_pairs]
    for ((B, T, H, hd), chunk, seed, (dtype, logw_dtype),
         (shift, floor)) in wkv_cases:
        args = _wkv_inputs(B, T, H, hd, dtype, logw_dtype, seed=seed,
                           decay_shift=shift, floor=floor)
        errs, ok = [], True
        for o, p in zip(ops.wkv(*args, chunk=chunk),
                        ops.wkv(*args, chunk=chunk, mode="plain")):
            e, good = compare(o, p, "wkv")
            errs.append(e)
            ok = ok and good
        torch.cuda.synchronize()
        cases.append({"kernel": "rwkv6_wkv", "shape": [B, T, H, hd],
                      "chunk": chunk,
                      "dtype": str(dtype).replace("torch.", ""),
                      "logw_dtype": str(logw_dtype).replace("torch.", ""),
                      "decay_shift": shift, "logw_floor": floor,
                      "y_err": errs[0], "S_err": errs[1], "ok": ok})
    # the lane-batched entries: held against the plain loop and, lane by
    # lane, against a solo launch on that lane's operands (bitwise)
    for (L, shape) in ((SERVE_LANES, REQ_SHAPE), (3, (1000003,)),
                       (5, (4, 100, 7))):
        for P in (1, 3, 5):
            for dtype in (torch.float32, torch.bfloat16):
                x, buf, xi, c = _lane_inputs(L, shape, P, dtype, seed=P + L)
                c0 = c[:, 0].contiguous()
                up = ops.sa_update_lanes(x, buf, xi, c0)
                fp, fc = ops.sa_fused_update_lanes(x, buf, xi, c)
                e1, ok1 = compare(up, ops.sa_update_lanes(
                    x, buf, xi, c0, mode="plain"), "combine")
                pp, pc = ops.sa_fused_update_lanes(x, buf, xi, c, mode="plain")
                e2, ok2 = compare(fp, pp, "combine")
                e3, ok3 = compare(fc, pc, "combine")
                solo = all(
                    torch.equal(up[l], ops.sa_update(x[l], buf[l], xi[l],
                                                     c0[l]))
                    and all(torch.equal(a, b) for a, b in zip(
                        (fp[l], fc[l]),
                        ops.sa_fused_update(x[l], buf[l], xi[l], c[l])))
                    for l in range(L))
                torch.cuda.synchronize()
                cases.append({"kernel": "sa_update_lanes+sa_fused_lanes",
                              "lanes": L, "shape": list(shape), "P": P,
                              "dtype": str(dtype).replace("torch.", ""),
                              "sa_update_lanes_err": e1,
                              "sa_fused_lanes_err": max(e2, e3),
                              "lanes_equal_solo_launches": solo,
                              "ok": ok1 and ok2 and ok3 and solo})
    bad = [c for c in cases if not c["ok"]]
    emit({"phase": "kernels", "ok": not bad, "tolerance": TOL,
          "cases": cases})
    require(not bad, f"kernels disagree with their plain versions: {bad}")

    # times at the main path's shapes (f32): sa_update as the kernel
    # combine's predictor call (P=3), sa_fused with P=3, and their sweep;
    # attention at DiT-XL/2's (8, 16, 256, 72)
    combine = combine_times(timings)
    B, H, S, hd = 8, 16, 256, 72
    q, k, v = _attn_inputs(B, H, H, S, S, hd, torch.float32, seed=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the kernel module's own count (kernels/flash_attention.py::cost)
    attn_ops, attn_bytes = flash_cost(B, H, H, S, S, hd, False, 4)
    # the bound of the function at f32 accuracy: both products as three
    # TF32 tensor-core products per multiply-add (as SDPA computes f32).
    # Information: the kernel's own split (Q K^T as f32 FMAs on the CUDA
    # cores, P V as 3xTF32), and both products as f32 FMAs (the earlier
    # kernel's design and bound)
    parts = {"qk_f32_cuda_cores": attn_ops / 2 / PEAK_F32_FLOP_PER_S * 1e3,
             "pv_3xtf32_tensor_cores":
                 3 * attn_ops / 2 / PEAK_TF32_FLOP_PER_S * 1e3,
             "bytes": attn_bytes / PEAK_BYTES_PER_S * 1e3}
    timings["flash_attention"] = {
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=False)),
        "plain_ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=False,
                                                        mode="plain")),
        "library_ms": time_ms(lambda: sdpa(q, k, v)),
        "library_kernels": _device_kernels(lambda: sdpa(q, k, v)),
        "bound": bound(attn_bytes, 3 * attn_ops, PEAK_TF32_FLOP_PER_S),
        "bound_peak": "TF32 tensor cores, 3 products per multiply-add",
        "bound_parts_ms": parts,
        "bound_f32_simt_ms": bound(attn_bytes, attn_ops)[0],
        "shape": [B, H, S, hd]}
    f = timings["flash_attention"]
    f["no_slower_than_library"] = f["ms"] <= f["library_ms"]
    # the head-dim-224 instance at zamba2-7b's two shapes
    for name, seed in (("lm", 41), ("denoiser", 43)):
        timings[f"flash_attention_hd224_{name}"] = _causal_flash_times(
            HYBRID_FLASH_SHAPES[name], seed=seed)
    # the WKV call of the RWKV6-3B denoiser (f32 inputs, as the model's)
    args = _wkv_inputs(*WKV_SHAPE, torch.float32, torch.float32, seed=5)
    timings["rwkv6_wkv"] = {
        "ms": time_ms(lambda: ops.wkv(*args, chunk=WKV_CHUNK)),
        "plain_ms": time_ms(lambda: ops.wkv(*args, chunk=WKV_CHUNK,
                                            mode="plain"), inner=5, samples=20),
        "library_ms": None,
        "bound": bound(*wkv_bytes_ops(*WKV_SHAPE, WKV_CHUNK)),
        "shape": [*WKV_SHAPE, WKV_CHUNK]}
    return {"phase": "kernel_times", "ok": True, "card_peaks": {
        "bytes_per_s": PEAK_BYTES_PER_S, "f32_flop_per_s": PEAK_F32_FLOP_PER_S,
        "tf32_flop_per_s": PEAK_TF32_FLOP_PER_S},
        "times": {name: {**t, "bound_ms": t["bound"][0],
                         "bound_by": t["bound"][1]}
                  for name, t in timings.items()}, **combine}


@contextlib.contextmanager
def held_against_plain(record: dict):
    """While active, every kernel call through ``kernels.ops`` is followed
    by the plain version on the same inputs; ``record[name]`` keeps the
    call count, the max abs error and whether every call was in
    tolerance. The plain calls launch no kernel and count nothing. Every
    solve inside runs eager (``samplers.eager()``): a CUDA graph replay
    would run no wrapper, and the comparison reads each call back."""
    from repro_torch.core.samplers import eager
    from repro_torch.kernels import ops
    names = {"sa_update": "sa_update", "sa_fused_update": "sa_fused",
             "sa_update_lanes": "sa_update",
             "sa_fused_update_lanes": "sa_fused",
             "flash_attention": "flash_attention", "wkv": "rwkv6_wkv"}
    kinds = {"flash_attention": "attention", "wkv": "wkv"}
    originals = {n: getattr(ops, n) for n in names}

    def wrap(fn_name, fn):
        kind = kinds.get(fn_name, "combine")

        def held(*args, **kw):
            out = fn(*args, **kw)
            ref = fn(*args, **dict(kw, mode="plain"))
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            rec = record.setdefault(names[fn_name], {
                "calls": 0, "max_abs_err": 0.0, "ok": True})
            rec["calls"] += 1
            if fn_name.endswith("_lanes"):
                rec["lane_calls"] = rec.get("lane_calls", 0) + 1
            for o, r in zip(outs, refs):
                e, ok = compare(o, r, kind)
                rec["max_abs_err"] = max(rec["max_abs_err"], e)
                rec["ok"] = rec["ok"] and ok
            return out
        return held

    for n, f in originals.items():
        setattr(ops, n, wrap(n, f))
    try:
        with eager():
            yield record
    finally:
        for n, f in originals.items():
            setattr(ops, n, f)


def phase_main_path(state: dict) -> dict:
    import torch
    from repro_torch.core import Denoiser, make_sampler
    from repro_torch.kernels import ops
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.models.common import ParamDef
    from repro_torch.models.tame import tame_networks
    dev = torch.device("cuda")
    dit = build_tame_dit_xl2()
    model, params, mu, schedule = (dit[k] for k in ("model", "params", "mu",
                                                    "schedule"))
    xT, g, contract = dit["xT"], dit["g"], dit["contract"]
    cfg = model.cfg
    plain_model = TransformerLM(dataclasses.replace(cfg, use_flash=False))

    def sampler(combine, precision):
        return make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                            corrector_order=3, mode="PEC", combine=combine,
                            precision=precision, schedule=schedule,
                            prediction="x0")

    probe = sampler("einsum", "f32")
    if contract["halvings"]:
        print(f"tame: adaLN weights damped by {contract['factor']} to "
              f"reach Jacobian gain < 1 at full width", flush=True)
    xis = [torch.randn(SHAPE, generator=g, device=dev)
           for _ in range(probe.spec.n_steps)]
    noise = lambda i: xis[i]
    den_flash = Denoiser(tame_networks(model, params, mu)[0], schedule,
                         prediction="x0")
    den_plain = Denoiser(tame_networks(plain_model, params, mu)[0],
                         schedule, prediction="x0")

    def solve(combine, precision, den=den_flash, x=xT):
        s = sampler(combine, precision)
        before = ops.launch_counts()
        t = time.perf_counter()
        out = s.sample(den, x, noise=noise)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = ops.launch_counts()
        return out, secs, {k: after[k] - before[k] for k in after}, s

    ops.reset_launch_counts()  # the main-path window starts here
    runs, outs = {}, {}
    for combine in ("fused", "kernel", "einsum"):
        for precision in ("f32", "bf16"):
            name = f"{combine}_{precision}"
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, cold, launches, s = solve(combine, precision)
            out2, steady, launches2, _ = solve(combine, precision)
            want = dict.fromkeys(ops.launch_counts(), 0) | {
                "flash_attention": 28 * NFE,
                "sa_fused": 19 if combine == "fused" else 0,
                "sa_update": 38 if combine == "kernel" else 0}
            require(launches == want and launches2 == want,
                    f"{name}: launches {launches}, expected {want}")
            require(bool(torch.isfinite(out).all()) and
                    tuple(out.shape) == SHAPE, f"{name}: bad output")
            outs[name] = out.float()
            runs[name] = {"cold_s": cold, "steady_s": steady,
                          "repeat_bitwise": bool(torch.equal(out, out2)),
                          "nfe": s.nfe, "steps": s.spec.n_steps,
                          "launches": launches,
                          "max_memory_allocated":
                              torch.cuda.max_memory_allocated(),
                          "memory_allocated_before": before}
    ref = outs["einsum_f32"]
    out_plain_attn, _, la, _ = solve("einsum", "f32", den=den_plain)
    require(la["flash_attention"] == 0, "plain-attention run launched flash")
    v = torch.randn(SHAPE, generator=g, device=dev)
    x_pert = xT + 1e-7 * xT.norm() / v.norm() * v
    out_pert, _, _, _ = solve("einsum", "f32", x=x_pert)
    gaps = {"kernel_vs_einsum_f32": rel_gap(outs["kernel_f32"], ref),
            "fused_vs_einsum_f32": rel_gap(outs["fused_f32"], ref),
            "flash_vs_plain_attention_f32": rel_gap(ref, out_plain_attn),
            "perturbation_yardstick_f32": rel_gap(out_pert, ref),
            "kernel_vs_einsum_bf16": rel_gap(outs["kernel_bf16"],
                                             outs["einsum_bf16"]),
            "fused_vs_einsum_bf16": rel_gap(outs["fused_bf16"],
                                            outs["einsum_bf16"]),
            "bf16_vs_f32_einsum": rel_gap(outs["einsum_bf16"], ref)}
    held: dict = {}
    with held_against_plain(held):
        solve("fused", "f32")
        solve("kernel", "f32")
    state["launches"]["dit"] = ops.launch_counts()  # window ends
    state["held"]["dit"] = held
    # the first solve's peak, for dryrun_path's prediction: the step's own
    # memory is the rise over what was allocated before it, plus its
    # parameters, x_T and noise, allocated before it and live throughout
    own = sum(t.numel() * t.element_size() for t in _leaves(params)) \
        + sum(t.numel() * t.element_size() for t in [xT, *xis])
    run = runs["fused_f32"]
    state.setdefault("peaks", {})["dit_solve"] = {
        "measured_bytes": run["max_memory_allocated"]
        - run["memory_allocated_before"] + own,
        "what": "main_path's fused f32 DiT-XL/2 solve (cold: eager warm-up "
                "and capture; then a replay): max_memory_allocated less the "
                "allocation before it, plus the parameters, x_T and noise "
                "it was given"}

    # information only: the same gaps on random weights (adaLN and
    # out_proj drawn like the other projections), beside their own
    # perturbation yardstick
    rp = init_params(torch.Generator(dev).manual_seed(10),
                     model.param_defs(), torch.float32, dev)
    gr = torch.Generator(dev).manual_seed(11)
    for path in (("blocks", "adaln"), ("denoiser", "out_proj")):
        shape = rp[path[0]][path[1]].shape
        rp[path[0]][path[1]] = ParamDef(shape, (None,) * len(shape),
                                        "scaled").materialize(gr, torch.float32, dev)
    den_rand = Denoiser(lambda x, t, c: model.denoise(rp, x, t), schedule,
                        prediction="x0")
    r_e, _, _, _ = solve("einsum", "f32", den=den_rand)
    r_k, _, _, _ = solve("kernel", "f32", den=den_rand)
    r_p, _, _, _ = solve("einsum", "f32", den=den_rand, x=x_pert)
    random_gaps = {"kernel_vs_einsum_f32": rel_gap(r_k, r_e),
                   "perturbation_yardstick_f32": rel_gap(r_p, r_e)}
    del rp, den_rand

    result = {"phase": "main_path", "ok": True, "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "heads": cfg.n_heads, "head_dim": cfg.hd, "d_ff": cfg.d_ff,
              "params": sum(t.numel() for t in _leaves(params)),
              "latent": list(SHAPE),
              "use_flash": cfg.use_flash, "weights": "tame",
              "weights_s": dit["weights_s"], "contractive": contract,
              "sampler": {"name": "sa", "nfe": NFE, "tau": 1.0,
                          "predictor_order": 3, "corrector_order": 3,
                          "mode": "PEC"},
              "runs": runs, "rel_gap_final": gaps, "gap_limit_f32": GAP_LIMIT,
              "random_weights_rel_gap_final (information)": random_gaps,
              "held_against_plain": held}
    f32_gaps = {k: v for k, v in gaps.items() if k.endswith("_f32")}
    bad = {k: v for k, v in f32_gaps.items() if not v <= GAP_LIMIT}
    held_bad = {k: v for k, v in held.items() if not v["ok"]}
    result["ok"] = not bad and not held_bad
    emit(result)
    require(not bad, f"f32 gaps above {GAP_LIMIT}: {bad}")
    require(not held_bad, f"kernel calls out of tolerance: {held_bad}")
    require(set(held) == set(PATH_KERNELS["dit"]),
            f"held calls missing: {held}")
    state["tame"] = (model, params, mu, schedule)
    return result


def _profile_solve(run) -> dict:
    """Device time of one ``run()`` (a steady solve) by kernel category,
    from torch.profiler, beside its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    cats = {"flash_attention": 0.0, "rwkv6_wkv": 0.0, "sa_combine": 0.0,
            "gemm": 0.0, "other": 0.0}
    top = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue  # host-side events; kernels are the device's
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if not dev_us:
            continue
        k = ev.key.lower()
        if "flash_kernel" in k:
            cat = "flash_attention"
        elif "wkv_kernel" in k:
            cat = "rwkv6_wkv"
        elif "sa_fused_kernel" in k or "sa_update_kernel" in k:
            cat = "sa_combine"
        elif "gemm" in k or "cutlass" in k or "xmma" in k or "cublas" in k:
            cat = "gemm"
        else:
            cat = "other"
        cats[cat] += dev_us / 1e3
        top.append((dev_us / 1e3, ev.key[:90], ev.count))
    busy = sum(cats.values())
    top.sort(reverse=True)
    return {"wall_ms": wall_ms,
            "device_ms_by_category": cats if busy else "not measured",
            "device_busy_ms": busy if busy else "not measured",
            "idle_share": (1 - busy / wall_ms) if busy else "not measured",
            "top_kernels": [{"ms": ms, "name": n, "calls": c}
                            for ms, n, c in top[:8]]}


def phase_profile(state: dict) -> dict:
    """Where one steady fused-f32 DiT-XL/2 solve spends device time, by
    kernel category, from torch.profiler; plus one backbone evaluation
    timed with CUDA events."""
    import torch
    from repro_torch.core import Denoiser, make_sampler
    from repro_torch.models.tame import tame_networks
    dev = torch.device("cuda")
    model, params, mu, schedule = state["tame"]
    s = make_sampler("sa", nfe=NFE, tau=1.0, combine="fused",
                     schedule=schedule, prediction="x0")
    net, _ = tame_networks(model, params, mu)
    den = Denoiser(net, schedule, prediction="x0")
    g = torch.Generator(dev).manual_seed(1)
    xT = s.init_noise(g, SHAPE)
    s.sample(den, xT, g)
    torch.cuda.synchronize()
    split = _profile_solve(lambda: s.sample(den, xT, g))
    tt = torch.tensor(0.5, device=dev)
    eval_ms = time_ms(lambda: net(xT, tt, None), inner=1, samples=10)
    return {"phase": "profile", "ok": True,
            "solve": "fused f32, steady (a CUDA graph replay)",
            **split, "backbone_eval_ms": eval_ms}


def build_tame_dit_xl2(denoiser_cond: int | None = None) -> dict:
    """The DiT phases' tame DiT-XL/2 on the card: seed 0, flash on, its
    adaLN damped until contractive on the x_T drawn from generator seed 1
    (the main path's x_T; ``g`` comes back advanced past the check), with
    the seconds the weights took. With ``denoiser_cond`` the DiT is
    class-conditional (``y_proj``), and per-sample one-hot classes drawn
    from ``g`` after x_T (``cond``, [8, denoiser_cond]) are in play while
    the gain is checked."""
    import torch
    from repro_torch.core import get_schedule, make_sampler
    from repro_torch.models.tame import ensure_contractive, tame_dit
    dev = torch.device("cuda")
    schedule = get_schedule("vp_linear")
    t0 = time.perf_counter()
    model, params, mu = tame_dit("dit-xl-2", smoke=False, seed=0,
                                 use_flash=True, denoiser_cond=denoiser_cond,
                                 device=dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    g = torch.Generator(dev).manual_seed(1)
    xT = make_sampler("sa", nfe=NFE, schedule=schedule).init_noise(g, SHAPE)
    cond = None
    if denoiser_cond is not None:
        classes = torch.randint(0, denoiser_cond, (SHAPE[0],), generator=g,
                                device=dev)
        cond = torch.nn.functional.one_hot(classes, denoiser_cond).float()
    contract = ensure_contractive(model, params, mu, xT, g, cond=cond)
    return {"model": model, "params": params, "mu": mu, "schedule": schedule,
            "xT": xT, "g": g, "contract": contract, "weights_s": weights_s,
            "cond": cond}


def _tame_dit_xl2(state: dict, last_user: bool = False):
    """The main path's tame DiT-XL/2 ``(model, params, mu, schedule)``
    (dropped from ``state`` for the ``last_user``), or the same one anew
    when a phase runs without the main path."""
    if "tame" in state:
        return state.pop("tame") if last_user else state["tame"]
    t = build_tame_dit_xl2()
    return t["model"], t["params"], t["mu"], t["schedule"]


def expected_launches(sampler, per_eval: int) -> dict:
    """Kernel launches of one solve, from the spec's per-step modes: under
    ``fused`` a step with a corrector launches sa_fused and a
    predictor-only step sa_update; under ``kernel`` two sa_update launches
    or one; under the cond fallback every step runs the corrector
    combine. The backbone launches flash ``per_eval`` times an
    evaluation."""
    from repro_torch.kernels import ops
    spec = sampler.spec
    M = spec.n_steps
    if spec.program is not None:
        flags = spec.program.mode_flags(M)
    else:
        uc = spec.corrector_order > 0
        flags = [(uc, uc and spec.mode == "PECE")] * M
    with_corrector = sum(uc for uc, _ in flags)
    if sampler.plan.statics[1] == ("cond",):
        with_corrector = M
    p_only = M - with_corrector
    combine = spec.combine
    return dict.fromkeys(ops.launch_counts(), 0) | {
        "flash_attention": per_eval * sampler.nfe,
        "sa_fused": with_corrector if combine == "fused" else 0,
        "sa_update": {"fused": p_only, "kernel": 2 * with_corrector + p_only,
                      "einsum": 0}[combine]}


def phase_programs_path(state: dict) -> dict:
    """Step programs and the SEEDS and DPM-Solver++ table rules over
    DiT-XL/2 at full width and depth (tame weights, latent [8, 256, 16],
    NFE budget 20, flash on), through the combine kernels, with the
    phase's own x_T and noise:

    1. the ``constant`` and ``order-ramp`` presets under ``fused``, f32,
       each ``torch.equal`` to the fixed-spec fused solve;
    2. ``pece-head`` stamped to NFE 20 (15 steps: 3 PECE, 12 PEC) under
       ``fused``/``kernel``/``einsum`` in f32 and ``fused``/``einsum`` in
       bf16;
    3. ``predictor-tail`` (PEC, then P) under ``fused`` and ``einsum``;
    4. alternating P/PEC over 19 steps (the cond fallback) under
       ``fused``/``kernel``/``einsum``;
    5. ``seeds`` and ``dpmpp_multistep``, predictor order 3, no corrector,
       tau 1, under ``kernel``/``fused``/``einsum``.

    Every solve: finite, launch counts exactly as its modes give them,
    flash 28 times its NFE. Kernel solves within GAP_LIMIT of einsum in
    f32 (beside an x_T-nudge yardstick) and GAP_LIMIT_BF16 in bf16; one
    more solve of each kernel run of 2-5 with every kernel call held
    against its plain version."""
    import torch
    from repro_torch.core import Denoiser, make_sampler
    from repro_torch.core.programs import StepProgram, program_preset_for_nfe
    from repro_torch.kernels import ops
    from repro_torch.models.tame import tame_networks
    dev = torch.device("cuda")
    model, params, mu, schedule = _tame_dit_xl2(state)
    per_eval = model.cfg.n_layers
    den = Denoiser(tame_networks(model, params, mu)[0], schedule,
                   prediction="x0")
    g = torch.Generator(dev).manual_seed(31)
    xT = make_sampler("sa", nfe=NFE, schedule=schedule).init_noise(g, SHAPE)
    xis = [torch.randn(SHAPE, generator=g, device=dev) for _ in range(NFE)]
    v = torch.randn(SHAPE, generator=g, device=dev)
    x_pert = xT + 1e-7 * xT.norm() / v.norm() * v
    alternating = StepProgram(mode=tuple("P" if i % 2 == 0 else "PEC"
                                         for i in range(NFE - 1)))
    families = dict(predictor_order=3, corrector_order=0, tau=1.0)
    specs = {  # label -> (family, program, make_sampler keywords)
        "fixed": ("sa", None, {}),
        "constant": ("sa", program_preset_for_nfe("constant", NFE), {}),
        "order_ramp": ("sa", program_preset_for_nfe("order-ramp", NFE), {}),
        "pece_head": ("sa", program_preset_for_nfe("pece-head", NFE), {}),
        "predictor_tail": ("sa", program_preset_for_nfe("predictor-tail",
                                                        NFE), {}),
        "cond": ("sa", alternating, {}),
        "seeds": ("seeds", None, families),
        "dpmpp": ("dpmpp_multistep", None, families),
    }

    def sampler(label, combine, precision="f32"):
        name, program, kw = specs[label]
        return make_sampler(name, nfe=NFE, schedule=schedule,
                            prediction="x0", combine=combine,
                            precision=precision, program=program, **kw)

    def solve(s, x=xT):
        want = expected_launches(s, per_eval)
        before = ops.launch_counts()
        t = time.perf_counter()
        out = s.sample(den, x, noise=lambda i: xis[i])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        require(launches == want,
                f"programs: {s.spec}: launches {launches}, expected {want}")
        require(bool(torch.isfinite(out).all()) and
                tuple(out.shape) == SHAPE, f"programs: {s.spec}: bad output")
        return out, secs, launches

    ops.reset_launch_counts()  # the programs main-path window starts here
    runs, outs = {}, {}
    held: dict = {}
    for label, combine, precision in (
            ("fixed", "fused", "f32"), ("constant", "fused", "f32"),
            ("order_ramp", "fused", "f32"),
            *[("pece_head", c, "f32") for c in ("fused", "kernel", "einsum")],
            ("pece_head", "fused", "bf16"), ("pece_head", "einsum", "bf16"),
            ("predictor_tail", "fused", "f32"),
            ("predictor_tail", "einsum", "f32"),
            *[(lb, c, "f32") for lb in ("cond", "seeds", "dpmpp")
              for c in ("fused", "kernel", "einsum")]):
        s = sampler(label, combine, precision)
        out, cold, launches = solve(s)
        out2, steady, _ = solve(s)
        key = f"{label}_{combine}_{precision}"
        outs[key] = out
        program = s.spec.program
        runs[key] = {
            "sampler": s.spec.name, "cold_s": cold, "steady_s": steady,
            "repeat_bitwise": bool(torch.equal(out, out2)),
            "steps": s.spec.n_steps, "nfe": s.nfe,
            "program": program.to_json() if program is not None else None,
            "segments": (program.segments(s.spec.n_steps)
                         if program is not None else None),
            "modes": repr(s.plan.statics[1]), "launches": launches}
        if combine != "einsum" and label not in ("fixed", "constant",
                                                 "order_ramp"):
            with held_against_plain(held):
                solve(s)
    out_pert, _, _ = solve(sampler("pece_head", "einsum"), x=x_pert)
    state["launches"]["programs"] = ops.launch_counts()  # window ends
    state["held"]["programs"] = held

    bitwise = {f"{lb}_vs_fixed_fused_f32": bool(torch.equal(
        outs[f"{lb}_fused_f32"], outs["fixed_fused_f32"]))
        for lb in ("constant", "order_ramp")}
    gaps = {"pece_head_perturbation_yardstick_f32": rel_gap(
        out_pert, outs["pece_head_einsum_f32"])}
    for key in outs:
        label, combine, precision = key.rsplit("_", 2)
        if combine in ("fused", "kernel") and label not in (
                "fixed", "constant", "order_ramp"):
            gaps[f"{label}_{combine}_vs_einsum_{precision}"] = rel_gap(
                outs[key], outs[f"{label}_einsum_{precision}"])
    bad = {k: g_ for k, g_ in gaps.items()
           if not g_ <= (GAP_LIMIT_BF16 if k.endswith("bf16") else GAP_LIMIT)}
    held_bad = {k: r for k, r in held.items() if not r["ok"]}
    live = sum(r.graph is not None for e in _cache_entries()
               for r in e.runs.values())
    result = {"phase": "programs_path", "arch": model.cfg.name,
              "live_graphs": live, "graph_pool_bytes": graph_pool_bytes(),
              "layers": model.cfg.n_layers, "d_model": model.cfg.d_model,
              "latent": list(SHAPE), "weights": "tame", "nfe_budget": NFE,
              "runs": runs, "bitwise_equal": bitwise, "rel_gap_final": gaps,
              "gap_limit_f32": GAP_LIMIT, "gap_limit_bf16": GAP_LIMIT_BF16,
              "held_against_plain": held,
              "ok": all(bitwise.values()) and not bad and not held_bad}
    emit(result)
    require(all(bitwise.values()),
            f"programs: constant programs not bitwise the fixed spec: "
            f"{bitwise}")
    require(not bad, f"programs: gaps above their limits: {bad}")
    require(not held_bad, f"programs: kernel calls out of tolerance: "
            f"{held_bad}")
    require(set(held) == set(PATH_KERNELS["programs"]),
            f"programs: held calls missing: {held}")
    return result


@contextlib.contextmanager
def flash_batches(record: dict):
    """While active, ``record[B]`` counts the flash_attention calls through
    ``kernels.ops`` at batch B (the wrapper's own count is untouched) that
    an eager solve makes: not those recorded into a CUDA graph (its
    capture follows an eager warm-up solve, which counts them) and none of
    a replay (which runs no Python)."""
    import torch
    from repro_torch.kernels import ops
    original = ops.flash_attention

    def counted(q, *args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            record[q.shape[0]] = record.get(q.shape[0], 0) + 1
        return original(q, *args, **kw)

    ops.flash_attention = counted
    try:
        yield record
    finally:
        ops.flash_attention = original


def _timed_solve(s, den, x, xis, **kw):
    """(output, seconds, launches, flash calls by batch, whether an eager
    solve ran) of one solve. An eager solve runs on an entry's first call
    of a graph signature (the warm-up its capture follows), under the
    residual feature-cache policy and inside ``eager()``; otherwise the
    call replays a graph, and its flash calls by batch are those of the
    eager solve it was captured after."""
    import torch
    from repro_torch.core.samplers import compile_cache_stats
    from repro_torch.kernels import ops
    before, stats = ops.launch_counts(), compile_cache_stats()
    batches: dict = {}
    with flash_batches(batches):
        t = time.perf_counter()
        out = s.sample(den, x, noise=lambda i: xis[i], **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
    after, stats2 = ops.launch_counts(), compile_cache_stats()
    require(bool(torch.isfinite(out).all()) and tuple(out.shape) == SHAPE,
            f"{s.spec}: bad output")
    ran_eager = (stats2["graphs"] > stats["graphs"]
                 or stats2["aot_fallbacks"] > stats["aot_fallbacks"])
    return (out, secs, {k: after[k] - before[k] for k in after}, batches,
            ran_eager)


def eager_batches(batches: dict, ran_eager: bool) -> dict:
    """The flash calls by batch that ``flash_batches`` sees in one solve:
    ``batches`` where an eager solve ran, none for a replay."""
    return batches if ran_eager else {}


#: ImageNet's classes: with one-hot vectors ``c @ y_proj`` is DiT's
#: label-embedding lookup
N_CLASSES = 1000
#: DiT's published FID guidance scale
CFG_SCALE = 1.5


def phase_guided_path(state: dict) -> dict:
    """Class-conditional DiT-XL/2 (full width and depth, ``denoiser_cond``
    1000, tame weights, contractive with its classes in play) under
    classifier-free guidance: SA NFE 20 P3C3 PEC tau 1, fused f32, flash,
    per-sample one-hot classes from the seed, scale 1.5, null = zeros.

    The package's one-call CFG (one backbone call over the doubled batch:
    560 flash launches at batch 16, 19 sa_fused) against a two-call
    baseline built here (1,120 flash launches at batch 8) and the unguided
    solve (560 at batch 8), cold and steady each. Gaps: one call vs two
    (f32 GEMMs over M = 4,096 vs 2,048 rows may round differently), scale
    1.0 vs unguided, and the guided kernel solve vs the all-plain one
    (einsum combine, plain attention), beside an x_T-nudge yardstick at
    the same scale; one guided solve with every kernel call held against
    its plain version."""
    import torch
    from repro_torch.core import Denoiser, make_sampler
    from repro_torch.kernels import ops
    from repro_torch.models import TransformerLM
    from repro_torch.models.tame import tame_networks
    dev = torch.device("cuda")
    dit = build_tame_dit_xl2(denoiser_cond=N_CLASSES)
    model, params, mu, schedule = (dit[k] for k in ("model", "params", "mu",
                                                    "schedule"))
    xT, g, cond = dit["xT"], dit["g"], dit["cond"]
    cfg = model.cfg
    L = cfg.n_layers
    net, _ = tame_networks(model, params, mu)
    plain_net, _ = tame_networks(
        TransformerLM(dataclasses.replace(cfg, use_flash=False)), params, mu)

    def sampler(guided, combine="fused"):
        return make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                            corrector_order=3, mode="PEC", combine=combine,
                            schedule=schedule, prediction="x0",
                            guidance=guided)

    s_u, s_g, s_gp = sampler(False), sampler(True), sampler(True, "einsum")
    M = s_g.spec.n_steps
    xis = [torch.randn(SHAPE, generator=g, device=dev) for _ in range(M)]
    v = torch.randn(SHAPE, generator=g, device=dev)
    x_pert = xT + 1e-7 * xT.norm() / v.norm() * v
    den_u = Denoiser(net, schedule, prediction="x0")
    den_g = Denoiser(net, schedule, prediction="x0", guidance=True,
                     cond_rank=1)
    den_gp = Denoiser(plain_net, schedule, prediction="x0", guidance=True,
                      cond_rank=1)
    null = torch.zeros_like(cond)
    scale = torch.tensor(CFG_SCALE, device=dev)

    def two_call(x, t):  # the baseline: each branch its own backbone call
        return Denoiser._combine(net(x, t, cond), net(x, t, null), scale)

    B = SHAPE[0]
    want_sa = {"sa_fused": M, "sa_update": 0, "rwkv6_wkv": 0}
    runs = {  # label -> (sampler, model, sample keywords, launches, batches)
        "unguided": (s_u, den_u, {"cond": cond},
                     {"flash_attention": L * NFE}, {B: L * NFE}),
        "two_call": (s_u, two_call, {}, {"flash_attention": 2 * L * NFE},
                     {B: 2 * L * NFE}),
        "one_call": (s_g, den_g, {"cond": cond, "guidance_scale": CFG_SCALE},
                     {"flash_attention": L * NFE}, {2 * B: L * NFE}),
    }
    ops.reset_launch_counts()  # the guided main-path window starts here
    outs, res = {}, {}
    for label, (s, den, kw, launches, batches) in runs.items():
        out, cold, l1, b1, e1 = _timed_solve(s, den, xT, xis, **kw)
        out2, steady, l2, b2, e2 = _timed_solve(s, den, xT, xis, **kw)
        want = want_sa | launches
        require(l1 == want and l2 == want and e1 and
                b1 == eager_batches(batches, e1) and
                b2 == eager_batches(batches, e2),
                f"guided: {label}: launches {l1} / {l2} at batches {b1} / "
                f"{b2}, expected {want} at {batches}")
        outs[label] = out
        res[label] = {"cold_s": cold, "steady_s": steady,
                      "repeat_bitwise": bool(torch.equal(out, out2)),
                      "launches": l1, "flash_calls_by_batch": b1}
    out_s1 = _timed_solve(s_g, den_g, xT, xis, cond=cond,
                          guidance_scale=1.0)[0]
    out_pert = _timed_solve(s_g, den_g, x_pert, xis, cond=cond,
                            guidance_scale=CFG_SCALE)[0]
    out_plain, _, l_plain, _, _ = _timed_solve(
        s_gp, den_gp, xT, xis, cond=cond, guidance_scale=CFG_SCALE)
    require(not any(l_plain.values()), f"guided: plain solve launched "
            f"{l_plain}")
    held: dict = {}
    with held_against_plain(held):
        _timed_solve(s_g, den_g, xT, xis, cond=cond, guidance_scale=CFG_SCALE)
    state["launches"]["guided"] = ops.launch_counts()  # window ends
    state["held"]["guided"] = held
    gaps = {"one_call_vs_two_call_f32": rel_gap(outs["one_call"],
                                                outs["two_call"]),
            "scale_1_vs_unguided_f32": rel_gap(out_s1, outs["unguided"]),
            "kernel_vs_plain_f32": rel_gap(outs["one_call"], out_plain),
            "perturbation_yardstick_f32": rel_gap(out_pert, outs["one_call"])}
    info = {"guided_vs_unguided": rel_gap(outs["one_call"], outs["unguided"]),
            "one_call_vs_two_call_bitwise": bool(torch.equal(
                outs["one_call"], outs["two_call"]))}
    bad = {k: g_ for k, g_ in gaps.items() if not g_ <= GAP_LIMIT}
    held_bad = {k: r for k, r in held.items() if not r["ok"]}
    result = {"phase": "guided_path", "arch": cfg.name, "layers": L,
              "d_model": cfg.d_model, "denoiser_cond": cfg.denoiser_cond,
              "latent": list(SHAPE), "weights": "tame",
              "weights_s": dit["weights_s"], "contractive": dit["contract"],
              "classes": cond.argmax(-1).tolist(), "guidance_scale":
                  CFG_SCALE, "sampler": {"name": "sa", "nfe": NFE,
                                         "tau": 1.0, "predictor_order": 3,
                                         "corrector_order": 3, "mode": "PEC",
                                         "combine": "fused"},
              "runs": res, "rel_gap_final": gaps, "gap_limit_f32": GAP_LIMIT,
              "information": info, "held_against_plain": held,
              "ok": not bad and not held_bad}
    emit(result)
    require(not bad, f"guided: gaps above {GAP_LIMIT}: {bad}")
    require(not held_bad, f"guided: kernel calls out of tolerance: {held_bad}")
    require(set(held) == set(PATH_KERNELS["guided"]),
            f"guided: held calls missing: {held}")
    return result


#: steady solves of each kind (eager, replay) per ``graph_path``
#: configuration, in turns (3 since the hybrid path took the time of the
#: fourth and fifth, 2 since the parallel path took the third's)
GRAPH_REPEATS = 2
#: the guidance scales ``graph_path`` sweeps through one entry
GRAPH_SCALES = (1.0, 1.5, 4.0)


def graph_pool_bytes():
    """Bytes of device memory in the compile cache's shared CUDA graph
    pool (its segments in the allocator's snapshot), or "not measured"
    where the snapshot does not name pools."""
    import torch
    from repro_torch.core.samplers import base
    pool = base._POOLS.get(torch.device("cuda", torch.cuda.current_device()))
    if pool is None:
        return 0
    segs = torch.cuda.memory_snapshot()
    if segs and "segment_pool_id" not in segs[0]:
        return "not measured"
    return sum(sg["total_size"] for sg in segs
               if tuple(sg["segment_pool_id"]) == tuple(pool))


def spread(xs) -> dict:
    """p50, p90, min and max of ``xs`` (p90 interpolated)."""
    xs = sorted(xs)
    return {"n": len(xs), "p50": statistics.median(xs),
            "p90": statistics.quantiles(xs, n=10, method="inclusive")[8],
            "min": xs[0], "max": xs[-1]}


#: the residual policy's threshold sweep in ``graph_path`` (one graph)
RESIDUAL_SWEEP = (0.02, 0.05, 0.08)


def residual_graph(run, sampler, den, kw, moved, per_reuse: int,
                   per_gate: int, M: int) -> dict:
    """``graph_path``'s residual policy (``residual:0.05``, a hit on the
    interval-2 entry with a signature of its own): its first call an eager
    warm-up and a capture (one new graph, no fallback), its replays equal
    to its ``eager()`` solve bit for bit; a threshold sweep (RESIDUAL_SWEEP)
    replays the same graph, each threshold equal to its own ``eager()``
    solve; GRAPH_REPEATS replays and eager solves in turns (p50/p90).
    Launches: an eager solve counts every flash call, 28 + 28 r + 8 (M -
    r) for r refreshing steps (1 planned + the gate's fires, read from the
    device counter); a replay counts the launches outside the gate (r = 1)
    and its gate fires equal the eager solve's."""
    import torch
    from repro_torch.core.samplers import compile_cache_stats, eager
    from repro_torch.kernels import graph_gate
    dev = torch.device("cuda", torch.cuda.current_device())

    def gated(s, eager_solve=False):
        graph_gate.reset_fires()
        if eager_solve:
            with eager():
                out, secs, launches = run(s, den, kw)
        else:
            out, secs, launches = run(s, den, kw)
        return out, secs, launches, graph_gate.fires(dev)

    def flash(fires):
        return residual_flash(per_reuse, per_gate, M, fires)

    rec: dict = {}
    s_res = sampler(fc=RESIDUAL_FC)
    st = compile_cache_stats()
    first, rec["cold_s"], l_first, f_first = gated(s_res)
    rec["first_call_stats"] = moved(st)
    replay, _, l_replay, f_replay = gated(s_res)
    ref, _, l_eager, f_eager = gated(s_res, eager_solve=True)
    rec["first_equals_eager_bitwise"] = bool(torch.equal(first, ref))
    rec["replay_equals_eager_bitwise"] = bool(torch.equal(replay, ref))
    rec["refreshing_steps"] = 1 + f_eager
    rec["gate_fires"] = {"first": f_first, "replay": f_replay,
                         "eager": f_eager}
    rec["flash_launches"] = {"first": l_first["flash_attention"],
                             "replay": l_replay["flash_attention"],
                             "eager": l_eager["flash_attention"]}
    require(rec["first_call_stats"] == {"hits": 1, "misses": 0,
                                        "graphs": 1, "aot_fallbacks": 0},
            f"graph: residual first call {rec['first_call_stats']}")
    require(rec["first_equals_eager_bitwise"] and
            rec["replay_equals_eager_bitwise"],
            f"graph: residual solves differ from eager: "
            f"{rel_gap(replay, ref)}")
    require(f_first == f_replay == f_eager and
            rec["flash_launches"] == {"first": flash(f_eager),
                                      "replay": flash(0),
                                      "eager": flash(f_eager)} and
            0 < f_eager < M - 1,
            f"graph: residual gate fires {rec['gate_fires']}, flash "
            f"{rec['flash_launches']}")
    st = compile_cache_stats()
    sweep = {}
    for th in RESIDUAL_SWEEP:
        s_th = sampler(fc=("residual", th))
        out, _, _, fires = gated(s_th)
        out_e, _, _, fires_e = gated(s_th, eager_solve=True)
        sweep[th] = {"equals_eager_bitwise": bool(torch.equal(out, out_e)),
                     "refreshing_steps": 1 + fires_e,
                     "replay_gate_fires": fires,
                     "vs_0.05_rel_gap": rel_gap(out, ref)}
    sweep_stats = moved(st)
    rec["threshold_sweep"] = sweep
    rec["threshold_sweep_stats"] = sweep_stats
    n = len(RESIDUAL_SWEEP)
    require(sweep_stats == {"hits": 2 * n, "misses": 0, "graphs": 0,
                            "aot_fallbacks": n},
            f"graph: residual threshold sweep {sweep_stats}")
    require(all(v["equals_eager_bitwise"] and v["replay_gate_fires"] + 1
                == v["refreshing_steps"] for v in sweep.values()),
            f"graph: residual threshold sweep {sweep}")
    eager_s, replay_s = [], []
    for _ in range(GRAPH_REPEATS):
        eager_s.append(gated(s_res, eager_solve=True)[1])
        replay_s.append(gated(s_res)[1])
    rec["eager_s"], rec["replay_s"] = spread(eager_s), spread(replay_s)
    rec["replay_over_eager_p50"] = (rec["replay_s"]["p50"]
                                    / rec["eager_s"]["p50"])
    return rec


def phase_graph_path(state: dict) -> dict:
    """The compiled executor at DiT-XL/2 full width (the main path's tame
    model, latent [8, 256, 16], SA NFE 20 P3C3 PEC tau 1, flash): fused
    f32, kernel-combine bf16, one-call CFG at scale 1.5 (batch 16, a
    shared (256, 16) input-space prompt) and feature caching at interval
    2, each through its own compile-cache entry with the phase's x_T and
    one [19, 8, 256, 16] noise buffer. For each:

    - the first call (an eager warm-up solve, then the capture) is one
      miss and one graph; the second call (a replay) and an ``eager()``
      solve equal it bit for bit, each with the launches of one solve;
    - a tau re-plan (0.5, same NFE) is a hit with no new graph and equals
      a fresh entry's solve bit for bit;
    - CFG: a scale sweep (1.0, 1.5, 4.0) adds no miss and no graph; 1.5
      equals the replay, 4.0 its ``eager()`` solve;
    - feature cache: the ``residual:0.05`` policy (a hit on another
      signature) is captured, its refresh gate a conditional node of the
      graph (``residual_graph``);
    - GRAPH_REPEATS steady eager solves and replays in turns (p50/p90),
      the shared graph pool's bytes before and after the capture, and the
      capture's peak allocation above what was allocated before it."""
    import torch
    from repro_torch.core import Denoiser, make_sampler
    from repro_torch.core.samplers import compile_cache_stats, eager
    from repro_torch.kernels import ops
    from repro_torch.models.tame import tame_networks
    dev = torch.device("cuda")
    model, params, mu, schedule = _tame_dit_xl2(state)
    L = model.cfg.n_layers
    a, b = model.cache_span()
    net, cached = tame_networks(model, params, mu)
    g = torch.Generator(dev).manual_seed(51)
    xT = make_sampler("sa", nfe=NFE, schedule=schedule).init_noise(g, SHAPE)
    M = NFE - 1
    xi = torch.randn((M,) + SHAPE, generator=g, device=dev)
    prompt = 0.1 * torch.randn(SHAPE[1:], generator=g, device=dev)

    def sampler(combine="fused", precision="f32", tau=1.0, guided=False,
                fc=None):
        return make_sampler("sa", nfe=NFE, tau=tau, predictor_order=3,
                            corrector_order=3, mode="PEC", combine=combine,
                            precision=precision, schedule=schedule,
                            prediction="x0", guidance=guided,
                            feature_cache=fc)

    def denoiser(guided, fc):
        return Denoiser(net, schedule, prediction="x0", guidance=guided,
                        cached=cached if fc is not None else None)

    def run(s, den, kw):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = s.sample(den, xT, noise=xi, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = ops.launch_counts()
        require(bool(torch.isfinite(out).all()) and tuple(out.shape) == SHAPE,
                f"graph: {s.spec}: bad output")
        return out, secs, {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}

    def moved(before):
        now = compile_cache_stats()
        return {k: now[k] - before[k]
                for k in ("hits", "misses", "graphs", "aot_fallbacks")}

    configs = {  # label -> (sampler keywords, sample keywords)
        "fused_f32": ({}, {}),
        "kernel_bf16": ({"combine": "kernel", "precision": "bf16"}, {}),
        "cfg_fused_f32": ({"guided": True},
                          {"cond": prompt, "guidance_scale": CFG_SCALE}),
        "fc2_fused_f32": ({"fc": 2}, {}),
    }
    ops.reset_launch_counts()  # the graph main-path window starts here
    results = {}
    for label, (skw, kw) in configs.items():
        s = sampler(**skw)
        guided, fc = skw.get("guided", False), skw.get("fc")
        den = denoiser(guided, fc)
        refreshing = sum(s.plan.arrays["fc_refresh"]) if fc else M
        want = {"flash_attention": L + L * refreshing
                + (L - (b - a)) * (M - refreshing)}
        if skw.get("combine") == "kernel":
            want["sa_update"] = 2 * M
        else:
            want["sa_fused"] = M
        rec: dict = {"sampler": repr(s.spec), "want_launches": want}

        st = compile_cache_stats()
        pool0 = graph_pool_bytes()
        alloc0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        first, rec["cold_s"], l_first = run(s, den, kw)
        rec["capture_peak_bytes_above_allocated"] = \
            torch.cuda.max_memory_allocated() - alloc0
        rec["pool_bytes_before_after_capture"] = [pool0, graph_pool_bytes()]
        rec["first_call_stats"] = moved(st)
        replay, _, l_replay = run(s, den, kw)
        with eager():
            ref, _, l_eager = run(s, den, kw)
        rec["replay_equals_eager_bitwise"] = bool(torch.equal(replay, ref))
        rec["first_equals_eager_bitwise"] = bool(torch.equal(first, ref))
        rec["launches"] = {"first": l_first, "replay": l_replay,
                           "eager": l_eager}
        emit({"phase": "graph_path", "progress": label, **rec})
        require(rec["first_call_stats"] == {"hits": 0, "misses": 1,
                                            "graphs": 1, "aot_fallbacks": 0},
                f"graph: {label}: first call {rec['first_call_stats']}")
        require(rec["replay_equals_eager_bitwise"] and
                rec["first_equals_eager_bitwise"],
                f"graph: {label}: replay or first call not bitwise eager: "
                f"{rel_gap(replay, ref)}")
        require(l_first == l_replay == l_eager == want,
                f"graph: {label}: launches {rec['launches']}, expected {want}")

        # a tau re-plan at the same NFE: a hit that replays the same graph
        st = compile_cache_stats()
        replanned, _, l_rp = run(sampler(**skw, tau=0.5), den, kw)
        rec["replan_stats"] = moved(st)
        fresh_den = denoiser(guided, fc)
        fresh = run(sampler(**skw, tau=0.5), fresh_den, kw)[0]
        del fresh_den  # its entry and graph go with it
        rec["replan_equals_fresh_bitwise"] = bool(torch.equal(replanned,
                                                              fresh))
        require(rec["replan_stats"] == {"hits": 1, "misses": 0, "graphs": 0,
                                        "aot_fallbacks": 0} and l_rp == want,
                f"graph: {label}: re-plan {rec['replan_stats']}, {l_rp}")
        require(rec["replan_equals_fresh_bitwise"],
                f"graph: {label}: re-plan not bitwise a fresh entry's solve: "
                f"{rel_gap(replanned, fresh)}")
        require(not torch.equal(replanned, replay),
                f"graph: {label}: the re-plan solved the old plan")

        if guided:
            st = compile_cache_stats()
            sweep = {sc: run(s, den, dict(kw, guidance_scale=sc))
                     for sc in GRAPH_SCALES}
            rec["scale_sweep_stats"] = moved(st)
            with eager():
                ref4 = run(s, den, dict(kw, guidance_scale=4.0))[0]
            rec["scale_sweep"] = {
                "scale_1.5_equals_replay": bool(torch.equal(
                    sweep[CFG_SCALE][0], replay)),
                "scale_4_equals_eager": bool(torch.equal(sweep[4.0][0],
                                                         ref4)),
                "scale_4_vs_1.5": rel_gap(sweep[4.0][0], replay),
                "scale_1_vs_1.5": rel_gap(sweep[1.0][0], replay)}
            require(rec["scale_sweep_stats"] == {"hits": 3, "misses": 0,
                                                 "graphs": 0,
                                                 "aot_fallbacks": 0},
                    f"graph: scale sweep {rec['scale_sweep_stats']}")
            require(rec["scale_sweep"]["scale_1.5_equals_replay"] and
                    rec["scale_sweep"]["scale_4_equals_eager"] and
                    rec["scale_sweep"]["scale_4_vs_1.5"] > 0 and
                    all(l == want for _, _, l in sweep.values()),
                    f"graph: scale sweep {rec['scale_sweep']}")

        if fc is not None:
            rec["residual"] = residual_graph(run, sampler, den, kw, moved,
                                             L - (b - a), b - a, M)

        eager_s, replay_s = [], []
        for _ in range(GRAPH_REPEATS):
            with eager():
                _, secs, l_e = run(s, den, kw)
            eager_s.append(secs)
            _, secs, l_r = run(s, den, kw)
            replay_s.append(secs)
            require(l_e == l_r == want, f"graph: {label}: steady launches "
                    f"{l_e} / {l_r}, expected {want}")
        rec["eager_s"], rec["replay_s"] = spread(eager_s), spread(replay_s)
        rec["replay_over_eager_p50"] = (rec["replay_s"]["p50"]
                                        / rec["eager_s"]["p50"])
        results[label] = rec
    state["launches"]["graph"] = ops.launch_counts()  # window ends
    live = sum(r.graph is not None for e in _cache_entries()
               for r in e.runs.values())
    res = {"phase": "graph_path", "arch": model.cfg.name, "layers": L,
           "latent": list(SHAPE), "weights": "tame", "nfe": NFE,
           "repeats": GRAPH_REPEATS, "configs": results,
           "cache": compile_cache_stats(), "live_graphs": live,
           "pool_bytes": graph_pool_bytes(),
           "memory_stats": {k: torch.cuda.memory_stats()[k] for k in (
               "reserved_bytes.all.current", "allocated_bytes.all.current")},
           "ok": True}
    emit(res)
    return res


#: the serve phase's generator seeds (the engine's defaults)
SERVE_SEEDS = (7, 8)
#: guided requests' scales: DiT's FID setting and a strong one
SERVE_SCALES = (CFG_SCALE, 4.0)


def launch_window(fn):
    """(result, seconds, launches, compile-cache and step-cache deltas) of
    ``fn()``, synchronized."""
    import torch
    from repro_torch.core.samplers import (compile_cache_stats,
                                           stepwise_cache_stats)
    from repro_torch.kernels import ops
    before, c0, s0 = (ops.launch_counts(), compile_cache_stats(),
                      stepwise_cache_stats())
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    after, c1, s1 = (ops.launch_counts(), compile_cache_stats(),
                     stepwise_cache_stats())
    return (out, secs, {k: after[k] - before[k] for k in after},
            {k: c1[k] - c0[k] for k in ("hits", "misses", "graphs")},
            {k: s1[k] - s0[k] for k in ("hits", "misses", "graphs")})


def only_launches(**counts) -> dict:
    """Every kernel's launch count: ``counts``, and 0 for the rest."""
    from repro_torch.kernels import ops
    return dict.fromkeys(ops.launch_counts(), 0) | counts


def served_draws(rid: int, n_steps: int, prior: float):
    """The x_T and step noise that a ServeEngine with the default seeds
    (SERVE_SEEDS) draws for request ``rid`` of shape REQ_SHAPE."""
    import torch
    from repro_torch.serve import request_draws
    z, noise = request_draws(*SERVE_SEEDS, rid, 0, REQ_SHAPE, n_steps,
                             torch.device("cuda"))
    return prior * z, noise


def solo_solve(sam, model_, rid: int, prior: float, **kw):
    """Served request ``rid`` solved alone at batch 1 from its draws."""
    x, noise = served_draws(rid, sam.spec.n_steps, prior)
    return sam.sample(model_, x[None], noise=noise[:, None], **kw)[0]


def drive_ticks(eng, after_tick=None, sync: bool = False) -> list:
    """Step a step-scheduler ``eng`` until no request is pending or
    running; the seconds of each tick (synchronized when ``sync``).
    ``after_tick()`` runs after each tick, outside its time."""
    import torch
    ticks = []
    while eng.pending() or eng.health()["running_batches"]:
        t = time.perf_counter()
        eng.step()
        if sync:
            torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t)
        if after_tick is not None:
            after_tick()
    return ticks


def phase_serve_path(state: dict) -> dict:
    """The port's serving entry points at DiT-XL/2 full width:
    ``ServeEngine`` over the class-conditional tame DiT-XL/2
    (``denoiser_cond`` 1000; 28 layers, d_model 1152, 16 heads of 72),
    requests of one (256, 16) f32 latent each, SA NFE 20 P3C3 PEC tau 1,
    fused, flash. Every request draws its x_T and step noise from the
    engine's per-rid generators (``request_draws``), so each one can be
    solved again alone.

    - Solve scheduler, buckets (1, 2, 4, 8): 11 requests (a bucket of 8,
      a ragged 3 padded to 4), then 4 at tau 0.5 (new buckets that hit the
      warmed entry: no miss). Each result against a solo ``sample()`` of
      its request at batch 1 (gate 1e-4 relative, beside an x_T-nudge
      yardstick), and one streamed request's M previews.
    - Step scheduler, 8 lanes: 16 requests; 8 fill the batch (two exit
      early), 8 more join as lanes free (submitted from ``on_result``),
      one of them in a second batch that a merge migrates. Full-length
      results against the solve scheduler's (buckets of 8, the same GEMM
      shapes: bitwise expected, gated at 1e-4); the migrated request
      against its own unmigrated run (bitwise); no step-cache miss after
      the first tick.
    - Guided: 4 class-conditional requests at scales 1.5 and 4.0 in one
      bucket of 8 (one flash call at batch 16 per evaluation), each
      against its solo guided ``sample()``.
    - Fault: a NaN into one lane of 8 under the numerical guard: that
      request ends ``failed_numerics``, every other lane equals its
      fault-free run bit for bit.

    Launches are exact per run: 28 flash per evaluation, one sa_fused per
    solve step (solo, solve scheduler) or per tick (lane-batched, step
    scheduler), eager warm-up solves and ticks included. One eager run of
    each scheduler holds every kernel call against its plain version."""
    import torch
    from repro_torch.core import Denoiser, make_sampler
    from repro_torch.core.samplers import (compile_cache_stats,
                                           stepwise_cache_stats)
    from repro_torch.kernels import ops
    from repro_torch.models.tame import tame_networks
    from repro_torch.serve import Fault, FaultInjector, FaultPlan, ServeEngine
    dev = torch.device("cuda")
    dit = build_tame_dit_xl2(denoiser_cond=N_CLASSES)
    model, params, mu, schedule = (dit[k] for k in ("model", "params", "mu",
                                                    "schedule"))
    L = model.cfg.n_layers
    net, _ = tame_networks(model, params, mu)
    den = Denoiser(net, schedule, prediction="x0")
    den_g = Denoiser(net, schedule, prediction="x0", guidance=True,
                     cond_rank=1)

    def sampler(tau=1.0, guided=False):
        return make_sampler("sa", nfe=NFE, tau=tau, predictor_order=3,
                            corrector_order=3, mode="PEC", combine="fused",
                            schedule=schedule, prediction="x0",
                            guidance=guided)

    s, s_half, s_g = sampler(), sampler(tau=0.5), sampler(guided=True)
    M = s.spec.n_steps
    prior = schedule.prior_scale(float(s.plan.ts[0]))
    per_solve = {"flash_attention": L * NFE, "sa_fused": M}

    def solo(sam, model_, rid, **kw):
        return solo_solve(sam, model_, rid, prior, **kw)

    def want(solves=0, ticks=0):
        return only_launches(flash_attention=L * (NFE * solves + ticks),
                             sa_fused=M * solves + ticks)

    def check_launches(label, got, expected):
        require(got == expected, f"serve: {label}: launches {got}, "
                f"expected {expected}")

    def results_of(eng):
        return {r.rid: r for r in eng.run()}

    res: dict = {}
    ops.reset_launch_counts()  # the serve main-path window starts here

    # ---- solve scheduler: 11 requests, then 4 at tau 0.5
    first_solve = []
    eng = ServeEngine(den, bucket_sizes=(1, 2, 4, 8),
                      on_result=lambda r: first_solve.append(
                          time.perf_counter() - t_solve))
    for rid in range(11):
        eng.submit(s.spec, REQ_SHAPE, rid=rid)
    t_solve = time.perf_counter()
    out, secs, l1, c1, _ = launch_window(lambda: results_of(eng))
    first_s = first_solve[0]
    st = eng.stats()
    check_launches("solve", l1, want(solves=st["microbatches"]
                                     + c1["graphs"]))
    require(st["microbatches"] == 2 and st["padded_slots"] == 1
            and c1["misses"] == 2 and c1["graphs"] == 2,
            f"serve: solve buckets {st}, cache {c1}")
    for rid in range(11, 15):
        eng.submit(s_half.spec, REQ_SHAPE, rid=rid)
    out2, secs2, l2, c2, _ = launch_window(lambda: results_of(eng))
    check_launches("solve tau 0.5", l2, want(solves=1))
    require(c2["misses"] == 0 and c2["graphs"] == 0,
            f"serve: tau 0.5 buckets missed the warmed entry: {c2}")
    out.update(out2)
    gaps, l_solo = {}, {}
    for rid, r in sorted(out.items()):
        ref, _, ls, _, _ = launch_window(
            lambda: solo(s if rid < 11 else s_half, den, rid))
        require(r.status == "ok" and tuple(r.x0.shape) == REQ_SHAPE and
                bool(torch.isfinite(r.x0).all()), f"serve: rid {rid}: {r}")
        check_launches(f"solo {rid}", ls, want(solves=1))
        gaps[rid] = rel_gap(r.x0, ref)
    x0, n0 = served_draws(0, M, prior)
    v = torch.randn(REQ_SHAPE, generator=torch.Generator(dev).manual_seed(5),
                    device=dev)
    x_pert = x0 + 1e-7 * x0.norm() / v.norm() * v
    pert = s.sample(den, x_pert[None], noise=n0[:, None])[0]
    yardstick = rel_gap(pert, solo(s, den, 0))
    eng_stream = ServeEngine(den, bucket_sizes=(1,), stream=True)
    eng_stream.submit(s.spec, REQ_SHAPE, rid=0)
    streamed, _, l3, c3, _ = launch_window(lambda: results_of(eng_stream))
    require(streamed[0].status == "ok", f"serve: stream {streamed}")
    check_launches("stream", l3, want(solves=1 + c3["graphs"]))
    pv = streamed[0].previews
    require(tuple(pv.shape) == (M,) + REQ_SHAPE and
            bool(torch.isfinite(pv).all()) and
            torch.equal(pv[-1], streamed[0].x0),
            f"serve: stream previews {tuple(pv.shape)}")
    res["solve"] = {
        "requests": 15, "buckets": {"first": [8, 4], "tau_0.5": [4]},
        "seconds": secs + secs2, "first_run_s": secs,
        "time_to_first_result_s": first_s,
        "requests_per_s": eng.stats()["requests_per_s"],
        "stats": {k: eng.stats()[k] for k in (
            "microbatches", "padded_slots", "warmups", "model_evals",
            "network_evals")},
        "cache_first_run": c1, "cache_tau_0.5": c2,
        "vs_solo_rel_gap": {"max": max(gaps.values()), "by_rid": gaps},
        "solo_bitwise": {rid: bool(torch.equal(out[rid].x0, solo(
            s if rid < 11 else s_half, den, rid))) for rid in (0, 8, 11)},
        "perturbation_yardstick_f32": yardstick,
        "stream": {"previews": list(pv.shape),
                   "x0_vs_solo_rel_gap": rel_gap(streamed[0].x0,
                                                 solo(s, den, 0))}}
    require(max(gaps.values()) <= GAP_LIMIT and yardstick <= GAP_LIMIT,
            f"serve: solve results vs solo: {gaps}, yardstick {yardstick}")

    # ---- step scheduler: 16 requests over 8 lanes with churn
    rids = list(range(100, 116))
    joiners = rids[8:]
    per_result = [2, 1] + [1] * 6  # joiners submitted by each result
    step_out: dict = {}
    first_step = []

    def on_result(r):
        if not first_step:
            first_step.append(time.perf_counter() - t_start)
        step_out[r.rid] = r
        k = per_result.pop(0) if per_result else 0
        for _ in range(min(k, len(joiners))):
            eng.submit(s.spec, REQ_SHAPE, rid=joiners.pop(0))

    eng = ServeEngine(den, scheduler="step", lanes=SERVE_LANES,
                      on_result=on_result)
    for rid in rids[:8]:
        early = rid in (100, 101)
        eng.submit(s.spec, REQ_SHAPE, rid=rid,
                   early_exit_tol=1e3 if early else 0.0,
                   min_steps=4 if early else None)
    home: dict = {}
    migrated = set()
    s_churn0 = None

    def track():
        nonlocal s_churn0
        if s_churn0 is None:
            s_churn0 = stepwise_cache_stats()
        for batch in eng._batcher._batches:  # which batch holds each rid
            for req in batch.requests:
                if req is None:
                    continue
                if home.get(req.rid, id(batch)) != id(batch):
                    migrated.add(req.rid)
                home[req.rid] = id(batch)

    t_start = time.perf_counter()
    tick_s, secs, l4, c4, s4 = launch_window(lambda: drive_ticks(eng, track))
    st = eng.stats()
    s_end = stepwise_cache_stats()
    check_launches("step", l4, want(ticks=st["ticks"] + s4["graphs"]))
    full = [r for r in rids if step_out[r].n_steps == M]
    require(set(step_out) == set(rids) and
            all(step_out[r].status == "ok" for r in rids) and
            [step_out[r].n_steps for r in (100, 101)] == [4, 4] and
            len(full) == 14 and st["migrations"] >= 1 and migrated,
            f"serve: step churn: {sorted(step_out)}, migrations "
            f"{st['migrations']} {sorted(migrated)}")
    require(s_end["misses"] == s_churn0["misses"],
            f"serve: step-cache misses after warmup: {s_churn0} -> {s_end}")
    ref_eng = ServeEngine(den, bucket_sizes=(SERVE_LANES,))
    for rid in rids:
        ref_eng.submit(s.spec, REQ_SHAPE, rid=rid)
    ref_out, _, l5, c5, _ = launch_window(lambda: results_of(ref_eng))
    check_launches("step reference", l5, want(solves=2 + c5["graphs"]))
    step_gaps = {r: rel_gap(step_out[r].x0, ref_out[r].x0) for r in full}
    step_bitwise = {r: bool(torch.equal(step_out[r].x0, ref_out[r].x0))
                    for r in full}
    mig = min(migrated)
    alone = ServeEngine(den, scheduler="step", lanes=SERVE_LANES)
    alone.submit(s.spec, REQ_SHAPE, rid=mig)
    alone_out, _, l6, _, s6 = launch_window(lambda: results_of(alone))
    st6 = alone.stats()
    check_launches("step alone", l6, want(ticks=st6["ticks"] + s6["graphs"]))
    mig_bitwise = bool(torch.equal(alone_out[mig].x0, step_out[mig].x0))
    res["step"] = {
        "requests": 16, "lanes": SERVE_LANES, "seconds": secs,
        "ticks": st["ticks"], "tick_ms": spread([1e3 * t for t in tick_s]),
        "time_to_first_result_s": first_step[0],
        "requests_per_s": st["requests_per_s"],
        "joins": st["joins"], "migrations": st["migrations"],
        "migrated_rids": sorted(migrated),
        "early_exit_steps": {r: step_out[r].n_steps for r in (100, 101)},
        "buckets": st["buckets"], "step_cache": s_end,
        "step_cache_after_first_tick": s_churn0,
        "vs_solve_scheduler": {"rel_gap_max": max(step_gaps.values()),
                               "all_bitwise": all(step_bitwise.values()),
                               "bitwise_by_rid": step_bitwise},
        "migrated_equals_unmigrated_bitwise": mig_bitwise}
    require(max(step_gaps.values()) <= GAP_LIMIT,
            f"serve: step vs solve scheduler gaps {step_gaps}")
    require(mig_bitwise, f"serve: migrated rid {mig} moved: "
            f"{rel_gap(alone_out[mig].x0, step_out[mig].x0)}")

    # ---- guided: 4 class-conditional requests, one bucket of 8
    gen = torch.Generator(dev).manual_seed(9)
    classes = torch.randint(0, N_CLASSES, (4,), generator=gen, device=dev)
    conds = torch.nn.functional.one_hot(classes, N_CLASSES).float()
    scales = [SERVE_SCALES[i % 2] for i in range(4)]
    eng_g = ServeEngine(den_g, bucket_sizes=(SERVE_LANES,))
    for i in range(4):
        eng_g.submit(s_g.spec, REQ_SHAPE, rid=200 + i, cond=conds[i],
                     guidance_scale=scales[i])
    batches: dict = {}
    with flash_batches(batches):
        g_out, secs_g, l7, c7, _ = launch_window(lambda: results_of(eng_g))
    require(sorted(g_out) == [200, 201, 202, 203] and
            all(r.status == "ok" for r in g_out.values()),
            f"serve: guided results {g_out}")
    check_launches("guided", l7, want(solves=1 + c7["graphs"]))
    require(batches == {2 * SERVE_LANES: L * NFE},
            f"serve: guided flash calls by batch {batches}")
    g_gaps = {}
    for i in range(4):
        ref = solo(s_g, den_g, 200 + i, cond=conds[i][None],
                   guidance_scale=scales[i])
        g_gaps[200 + i] = rel_gap(g_out[200 + i].x0, ref)
    res["guided"] = {"requests": 4, "bucket": SERVE_LANES,
                     "classes": classes.tolist(), "scales": scales,
                     "seconds": secs_g,
                     "flash_calls_by_batch_eager_warmup": batches,
                     "vs_solo_rel_gap": g_gaps,
                     "scale_4_vs_1.5_rel_gap": rel_gap(g_out[201].x0,
                                                       g_out[200].x0)}
    require(max(g_gaps.values()) <= GAP_LIMIT,
            f"serve: guided vs solo gaps {g_gaps}")

    # ---- fault: a NaN into one lane under the guard
    f_rids = list(range(300, 300 + SERVE_LANES))

    def fault_run(plan):
        e = ServeEngine(den, scheduler="step", lanes=SERVE_LANES,
                        guard_interval=2,
                        fault_injector=FaultInjector(plan) if plan else None)
        for rid in f_rids:
            e.submit(s.spec, REQ_SHAPE, rid=rid)
        return e, {r.rid: r for r in e.run()}

    clean_eng, clean = fault_run(None)
    inj_plan = FaultPlan((Fault("nan", tick=5, rid=302),))
    f_eng, faulted = fault_run(inj_plan)
    neighbours = [r for r in f_rids if r != 302]
    res["fault"] = {
        "plan": [dataclasses.asdict(f) for f in inj_plan.faults],
        "status": {r: faulted[r].status for r in f_rids},
        "neighbours_bitwise": all(torch.equal(faulted[r].x0, clean[r].x0)
                                  for r in neighbours),
        "health": f_eng.health()}
    require(faulted[302].status == "failed_numerics" and
            all(faulted[r].status == "ok" for r in neighbours) and
            res["fault"]["neighbours_bitwise"],
            f"serve: fault run {res['fault']}")

    # ---- every kernel call held against its plain version (eager)
    held: dict = {}
    with held_against_plain(held):
        e = ServeEngine(den, scheduler="step", lanes=SERVE_LANES)
        for rid in range(400, 400 + SERVE_LANES):
            e.submit(s.spec, REQ_SHAPE, rid=rid)
        e.run()
        ticks_held = e.stats()["ticks"]
        e = ServeEngine(den, bucket_sizes=(4,))
        for rid in range(410, 413):
            e.submit(s.spec, REQ_SHAPE, rid=rid)
        e.run()
    state["launches"]["serve"] = ops.launch_counts()  # window ends
    state["held"]["serve"] = held
    held_bad = {k: r for k, r in held.items() if not r["ok"]}
    require(held.get("sa_fused", {}).get("lane_calls") == ticks_held,
            f"serve: lane-batched calls held {held}, ticks {ticks_held}")
    result = {"phase": "serve_path", "arch": model.cfg.name, "layers": L,
              "d_model": model.cfg.d_model,
              "denoiser_cond": model.cfg.denoiser_cond,
              "request_latent": list(REQ_SHAPE), "weights": "tame",
              "weights_s": dit["weights_s"], "contractive": dit["contract"],
              "sampler": {"name": "sa", "nfe": NFE, "tau": 1.0,
                          "predictor_order": 3, "corrector_order": 3,
                          "mode": "PEC", "combine": "fused"},
              "gap_limit_f32": GAP_LIMIT, **res,
              "compile_cache": compile_cache_stats(),
              "step_cache": stepwise_cache_stats(),
              "pool_bytes": graph_pool_bytes(),
              "held_against_plain": held, "ok": not held_bad}
    emit(result)
    require(not held_bad, f"serve: kernel calls out of tolerance: {held_bad}")
    require(set(held) == set(PATH_KERNELS["serve"]),
            f"serve: held calls missing: {held}")
    return result


#: the tune phase's GMM search: the reference's default search (NFE 8,
#: 4,000 NFE-equivalents, chunk 16 x 4 seeds = 64 lanes of one (512, 2)
#: point set) with the feature-cache unit, through the fused combine
TUNE_GMM = {"nfe": 8, "budget": 4000, "seed": 0,
            "fc_thresholds": (0.01, 0.05, 0.2),
            "spec_kw": {"combine": "fused"}}
#: a second search whose budget reaches every unit (the default one ends
#: inside its first, as the reference's does): two mode patterns and the
#: feature-cache unit, 3 groups
TUNE_GMM_UNITS = {"nfe": 8, "budget": 6000, "seed": 0,
                  "presets": ("tau-anneal", "predictor-tail"),
                  "tau_values": (0.0, 0.5, 1.0), "cd_passes": 1,
                  "evo_generations": 1, "fc_thresholds": (0.01, 0.05, 0.2),
                  "spec_kw": {"combine": "fused"}}
TUNE_LANES = 64
TUNE_GMM_SHAPE = (512, 2)
#: the DiT-XL/2 objective: 4 candidates x 2 seeds = the main path's 8
#: lanes, NFE 8, about 20 candidates (16 NFE-equivalents each)
TUNE_DIT = {"nfe": 8, "budget": 320, "seed": 0, "presets": ("nfe8-gmm",),
            "n_seeds": 2, "chunk": 4,
            "spec_kw": {"combine": "fused", "prediction": "x0"}}
#: the DiT score's target: each seed's SA NFE-20 P3C3 PEC tau-1 solve
TUNE_TARGET_NFE = 20
TUNE_PROJ = 64


def _search_groups(history, ev) -> int:
    """Distinct (statics, step count) groups of a search history, under
    the evaluator ``ev``'s spec mapping."""
    from repro_torch.core.programs import StepProgram
    from repro_torch.core.samplers import get_family
    keys = set()
    for h in history:
        spec = (ev.spec_for_fc(h["fc"]["tau"], h["fc"]["thresh"]) if "fc" in h
                else ev.spec_for(StepProgram.from_json(h["program"])))
        keys.add((get_family(spec.name).statics(spec), spec.n_steps))
    return len(keys)


def _merge_held(*records) -> dict:
    out: dict = {}
    for rec in records:
        for name, r in rec.items():
            o = out.setdefault(name, {"calls": 0, "max_abs_err": 0.0,
                                      "ok": True, "lane_calls": 0})
            o["calls"] += r["calls"]
            o["lane_calls"] += r.get("lane_calls", 0)
            o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
            o["ok"] = o["ok"] and r["ok"]
    return out


def _tune_cli(argv) -> list:
    """``launch.tune.main(argv)`` in this process; its printed lines."""
    import io
    from repro_torch.launch import tune as launch_tune
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_tune.main(argv)
    return out.getvalue().strip().splitlines()


def phase_tune_path(state: dict) -> dict:
    """The port's program autotuner on the card (``tune/``,
    ``launch.tune``, ``QualityTiers.from_artifact``): every chunk of
    candidates is one candidate-stacked solve (each lane under its own
    candidate's tables) through the lane entries of the combine kernels,
    one compile-cache entry and one CUDA graph per (statics, step count)
    group.

    - GMM: the reference's default search (``TUNE_GMM``, fused, 64 lanes
      of (512, 2); its budget ends inside the first unit), then one that
      reaches both program units and the feature-cache unit
      (``TUNE_GMM_UNITS``): candidates, dispatches, compiles, graphs (one
      per group, gated), NFE-equivalents, candidates/s, the winners. Three
      candidates scored in one chunk against each alone at the same chunk
      width (bitwise, gated); a chunk held against the plain combines
      (``held_against_plain``). Then ``launch.tune`` at its defaults
      (einsum) with ``--max-units 1`` and ``--resume``, whose history must
      equal an uninterrupted run's.
    - DiT-XL/2 (the main path's tame model, 28 layers, d_model 1152, f32,
      flash): a ``CallableObjective`` over (256, 16) latents, 2 seeds,
      chunk 4 (8 lanes), NFE 8, fused, the ``nfe8-gmm`` preset and a
      budget of 20 candidates, scored by the mean over seeds of the
      sliced W2 (64 fixed directions) to each seed's SA NFE-20 solve from
      the same x_T. The capture, seconds per replayed dispatch and
      launches per dispatch (against ``expected_launches``), the same
      chunk-vs-alone check (gated at GAP_LIMIT relative where not
      bitwise), a chunk held against the plain versions, and the
      artifact's winner served through ``QualityTiers.from_artifact`` as
      ``quality_tier="best"`` against the same spec given explicitly
      (bitwise, gated).
    """
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import Denoiser
    from repro_torch.core.metrics import sliced_w2_stat
    from repro_torch.core.programs import program_preset_for_nfe
    from repro_torch.core.samplers import (Sampler, SamplerSpec, build_plan,
                                           compile_cache_stats,
                                           sample_batched)
    from repro_torch.kernels import ops
    from repro_torch.models.tame import tame_networks
    from repro_torch.serve import QualityTiers, ServeEngine
    from repro_torch.tune import (CallableObjective, GMMObjective,
                                  ProgramEvaluator, SearchConfig, load_state,
                                  run_search)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    res: dict = {"phase": "tune_path"}
    ops.reset_launch_counts()  # the tune main-path window starts here

    # ---- GMM: the reference's default search, fused; then one whose
    # budget reaches every unit
    gmm_obj = GMMObjective(device="cuda")
    for key, kw in (("gmm", TUNE_GMM), ("gmm_units", TUNE_GMM_UNITS)):
        cfg = SearchConfig(**kw)
        c0 = compile_cache_stats()
        t = time.perf_counter()
        found = run_search(cfg, artifact=os.path.join(workdir, key + ".json"),
                           device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        graphs = compile_cache_stats()["graphs"] - c0["graphs"]
        groups = _search_groups(found.state["history"], ProgramEvaluator(
            gmm_obj, nfe=cfg.nfe, width=cfg.max_order, spec_kw=cfg.spec_kw))
        st = found.stats
        res[key] = {
            "config": cfg.to_obj(), "lanes": cfg.chunk * cfg.n_seeds,
            "lane_shape": list(TUNE_GMM_SHAPE), **st, "graphs": graphs,
            "groups": groups, "nfe_equivalents": found.state["budget_spent"],
            "seconds": secs, "candidates_per_s": st["candidates"] / secs,
            "units_done": found.state["unit"], "exhausted": found.exhausted,
            "best_score": found.best_score,
            "best_program": json.loads(found.best_program.to_json()),
            "best_fc": found.best_fc}
        require(st["compiles"] == groups and graphs == groups,
                f"tune {key}: {st['compiles']} compiles, {graphs} graphs for "
                f"{groups} (statics, n_steps) groups")
    require(res["gmm_units"]["best_fc"] is not None
            and res["gmm_units"]["groups"] == 3,
            f"tune: the units search {res['gmm_units']}")
    cfg = SearchConfig(**TUNE_GMM)
    ev = ProgramEvaluator(gmm_obj, nfe=8, chunk=cfg.chunk,
                          spec_kw=cfg.spec_kw)
    progs = [program_preset_for_nfe("tau-anneal", 8, tau=v)
             for v in (1.0, 0.6, 0.2)]
    batched = ev.evaluate(progs)
    solo = np.array([ev.evaluate([p])[0] for p in progs])
    res["gmm"]["chunk_vs_alone"] = {
        "batched": batched.tolist(), "alone": solo.tolist(),
        "bitwise": bool(np.array_equal(batched, solo))}
    require(np.array_equal(batched, solo) and len(set(batched)) == 3,
            f"tune: chunk scores {batched} vs alone {solo}")
    held_gmm: dict = {}
    with held_against_plain(held_gmm):
        ev.evaluate([program_preset_for_nfe(n, 8) for n in
                     ("tau-anneal", "predictor-tail")])
    res["gmm"]["held_against_plain"] = held_gmm

    # ---- launch.tune at its defaults (einsum), interrupted and resumed
    art = os.path.join(workdir, "cli.json")
    t = time.perf_counter()
    part = _tune_cli(["--artifact", art, "--max-units", "1"])
    resumed_lines = _tune_cli(["--artifact", art, "--resume"])
    full_lines = _tune_cli(["--artifact", os.path.join(workdir, "full.json")])
    cli_s = time.perf_counter() - t
    resumed = load_state(art)
    full = load_state(os.path.join(workdir, "full.json"))
    res["cli"] = {"seconds_three_runs": cli_s,
                  "evaluations": len(full["history"]),
                  "history_equal": resumed["history"] == full["history"],
                  "budget_spent": [resumed["budget_spent"],
                                   full["budget_spent"]],
                  "first_run_last_line": part[-1],
                  "resumed_lines": resumed_lines[-4:],
                  "full_lines": full_lines[-4:]}
    require(res["cli"]["history_equal"]
            and resumed["best"] == full["best"],
            "tune: the resumed CLI run's history differs from the "
            "uninterrupted run's")

    # ---- DiT-XL/2 at full width
    model, params, mu, schedule = _tame_dit_xl2(state)
    L = model.cfg.n_layers
    den = Denoiser(tame_networks(model, params, mu)[0], schedule,
                   prediction="x0")
    dirs = torch.randn((TUNE_PROJ, REQ_SHAPE[1]),
                       generator=torch.Generator().manual_seed(21)).cuda()
    target = {}

    def score(x0):
        return torch.mean(torch.stack([
            sliced_w2_stat(x0[s], target["x0"][s], dirs)
            for s in range(x0.shape[0])]))

    dcfg = SearchConfig(**TUNE_DIT)
    obj = CallableObjective(model=den, score=score, shape=REQ_SHAPE,
                            n_seeds=dcfg.n_seeds, seed=dcfg.seed,
                            device="cuda")
    tspec = SamplerSpec.from_nfe("sa", TUNE_TARGET_NFE, tau=1.0,
                                 combine="fused", prediction="x0")
    tnoise = torch.randn((dcfg.n_seeds, tspec.n_steps) + REQ_SHAPE,
                         generator=torch.Generator().manual_seed(22)).cuda()
    target["x0"] = sample_batched(build_plan(tspec), den, obj.init(tspec),
                                  noise=tnoise)
    ev = ProgramEvaluator(obj, nfe=dcfg.nfe, width=dcfg.max_order,
                          chunk=dcfg.chunk, spec_kw=dcfg.spec_kw)
    warm = program_preset_for_nfe("nfe8-gmm", dcfg.nfe)
    c0 = compile_cache_stats()
    t = time.perf_counter()
    ev.evaluate([warm])  # the entry, its eager warm-up and capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    t = time.perf_counter()
    found = run_search(dcfg, objective=obj,
                       artifact=os.path.join(workdir, "dit.json"))
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t
    graphs = compile_cache_stats()["graphs"] - c0["graphs"]
    groups = _search_groups(found.state["history"], ev)
    spec = ev.spec_for(warm)
    want = expected_launches(Sampler(spec), L)
    chunk = [warm.replace(tau=(v,) * warm.length()) for v in
             (1.0, 0.8, 0.5, 0.2)]
    per_dispatch, times = [], []
    for _ in range(3):
        before = ops.launch_counts()
        t = time.perf_counter()
        ev.evaluate(chunk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        after = ops.launch_counts()
        per_dispatch.append({k: after[k] - before[k] for k in after})
    batched = ev.evaluate(chunk[:3])
    solo = np.array([ev.evaluate([p])[0] for p in chunk[:3]])
    gap = float(np.max(np.abs(batched - solo) / np.abs(solo)))
    held_dit: dict = {}
    with held_against_plain(held_dit):
        ev.evaluate(chunk)
    # the winner served from the artifact, against its explicit spec
    tiers = QualityTiers.from_artifact(os.path.join(workdir, "dit.json"))
    best = tiers.resolve("best")
    e_tier = ServeEngine(den, tiers=tiers, bucket_sizes=(1,))
    e_tier.submit(None, REQ_SHAPE, rid=0, quality_tier="best")
    (r_tier,) = e_tier.run()
    e_spec = ServeEngine(den, bucket_sizes=(1,))
    e_spec.submit(best, REQ_SHAPE, rid=0)
    (r_spec,) = e_spec.run()
    state["launches"]["tune"] = ops.launch_counts()  # window ends
    held = _merge_held(held_gmm, held_dit)
    state["held"]["tune"] = held
    st = found.stats
    res["dit"] = {
        "arch": model.cfg.name, "layers": L, "d_model": model.cfg.d_model,
        "weights": "tame", "config": dcfg.to_obj(),
        "lanes": dcfg.chunk * dcfg.n_seeds, "latent": list(REQ_SHAPE),
        "score": f"mean over seeds of sliced W2^2 ({TUNE_PROJ} fixed "
                 f"directions) to the seed's SA NFE-{TUNE_TARGET_NFE} "
                 "P3C3 PEC tau-1 solve from the same x_T",
        **st, "graphs": graphs, "groups": groups,
        "capture_dispatch_s": capture_s, "search_s": search_s,
        "replayed_dispatch_s": times,
        "launches_per_dispatch": per_dispatch, "expected_launches": want,
        "chunk_vs_alone": {"batched": batched.tolist(),
                           "alone": solo.tolist(),
                           "bitwise": bool(np.array_equal(batched, solo)),
                           "max_rel_gap": gap, "gap_limit": GAP_LIMIT},
        "best_score": found.best_score,
        "best_program": json.loads(found.best_program.to_json()),
        "tier_best_bitwise": bool(torch.equal(r_tier.x0, r_spec.x0)),
        "tier_best_nfe": best.nfe, "held_against_plain": held_dit}
    held_bad = {k: r for k, r in held.items() if not r["ok"]}
    res.update(held_against_plain=held, compile_cache=compile_cache_stats(),
               ok=not held_bad)
    emit(res)
    require(graphs == groups == 1 and st["compiles"] == 1,
            f"tune dit: {graphs} graphs, {st['compiles']} compiles, {groups} "
            "groups")
    require(all(d == want for d in per_dispatch),
            f"tune dit: launches per dispatch {per_dispatch}, want {want}")
    require(gap <= GAP_LIMIT, f"tune dit: chunk vs alone gap {gap}")
    require(res["dit"]["tier_best_bitwise"],
            "tune dit: quality_tier='best' differs from its explicit spec")
    require(not held_bad, f"tune: kernel calls out of tolerance: {held_bad}")
    require(set(held) >= set(PATH_KERNELS["tune"])
            and held["sa_fused"]["lane_calls"] > 0
            and held.get("sa_update", {}).get("lane_calls", 0) > 0,
            f"tune: lane-kernel calls held {held}")
    return res


#: the paper's six baseline samplers (``core/samplers/baselines.py``)
BASELINES = ("ddim", "ddpm_ancestral", "dpm_solver_pp_2m", "euler_maruyama",
             "edm_heun", "edm_stochastic")
#: steady replays of each baseline in ``baselines_path`` (p50/p90; 2
#: since the hybrid path took the time of the third)
BASELINE_REPEATS = 2
#: the served baselines (the stochastic pair: one evaluation a tick, two)
SERVED_BASELINES = ("ddpm_ancestral", "edm_stochastic")
#: NFE of the baselines' GMM round trip (the reference's own,
#: tests/test_samplers.py), each gated below half the prior's sliced-W2
GMM_BASELINE_NFE = 32


def phase_baselines_path(state: dict) -> dict:
    """The paper's six baseline samplers at DiT-XL/2 full width (the main
    path's tame model, latent [8, 256, 16], flash), each at NFE 20 (ten
    Heun steps for the EDM pair, twenty steps for the rest), tau 1, the
    reference's default churn, through ``make_sampler(...).sample`` and
    the compile cache:

    - per family: a cold call (the eager warm-up solve and the capture:
      one miss, one graph), BASELINE_REPEATS steady replays (p50/p90),
      then one eager solve with every kernel call held against its plain
      version; the cold call and each replay equal the eager solve bit
      for bit, and every solve launches flash 28 times per evaluation it
      makes (the plan's Heun flags give the EDM count);
    - a ``ddim`` eta sweep (0.5, 1) and a tau-track program at 20 steps:
      hits with no new graph; ddim at eta 1 equals ``ddpm_ancestral``
      bit for bit (the same tables and noise);
    - ``edm_stochastic`` with plain attention within GAP_LIMIT of the
      flash solve;
    - one-call CFG (scale 1.5, flash at batch 16) for
      ``dpm_solver_pp_2m`` over the class-conditional tame DiT-XL/2
      (``denoiser_cond`` 1000), its solve held against plain too;
    - ``ServeEngine(scheduler="step")`` at 8 lanes over that model for
      ``ddpm_ancestral`` and ``edm_stochastic``: 12 requests each, 4 of
      them joining as lanes free, each within GAP_LIMIT of its solo
      solve; tick ms p50/p90;
    - ``launch.sample.main --arch dit-xl-2 --sampler edm_heun`` with no
      kernel flag (its own window: main sets the counts to 0), which must
      launch flash on every evaluation."""
    import io
    import torch
    from repro_torch.core import Denoiser, StepProgram, make_sampler
    from repro_torch.core.samplers import compile_cache_stats
    from repro_torch.kernels import ops
    from repro_torch.launch import sample as launch_sample
    from repro_torch.models import TransformerLM
    from repro_torch.models.tame import tame_networks
    from repro_torch.serve import ServeEngine
    dev = torch.device("cuda")
    model, params, mu, schedule = _tame_dit_xl2(state)
    L = model.cfg.n_layers
    net, _ = tame_networks(model, params, mu)
    plain_net, _ = tame_networks(
        TransformerLM(dataclasses.replace(model.cfg, use_flash=False)),
        params, mu)
    den = Denoiser(net, schedule, prediction="x0")
    den_plain = Denoiser(plain_net, schedule, prediction="x0")
    g = torch.Generator(dev).manual_seed(61)
    xT = make_sampler("sa", nfe=NFE, schedule=schedule).init_noise(g, SHAPE)
    noise = {M: torch.randn((M,) + SHAPE, generator=g, device=dev)
             for M in (NFE, NFE // 2)}

    def sampler(name, **kw):
        return make_sampler(name, nfe=NFE, tau=1.0, schedule=schedule,
                            prediction="x0", **kw)

    def evals(s) -> int:
        heun = s.plan.arrays.get("heun")
        return s.spec.n_steps + (sum(heun) if heun is not None else 0)

    def want(n_evals: int) -> dict:
        return only_launches(flash_attention=L * n_evals)

    def run(s, den_, x=xT, **kw):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = s.sample(den_, x, noise=noise[s.spec.n_steps], **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = ops.launch_counts()
        require(bool(torch.isfinite(out).all()) and
                tuple(out.shape) == tuple(x.shape),
                f"baselines: {s.spec.name}: bad output")
        return out, secs, {k: after[k] - before[k] for k in after}

    def moved(before):
        now = compile_cache_stats()
        return {k: now[k] - before[k]
                for k in ("hits", "misses", "graphs", "aot_fallbacks")}

    held: dict = {}

    def hold(rec: dict) -> None:
        """Fold one held solve's record into the phase's."""
        for k, r in rec.items():
            h = held.setdefault(k, {"calls": 0, "max_abs_err": 0.0,
                                    "ok": True})
            h["calls"] += r["calls"]
            h["max_abs_err"] = max(h["max_abs_err"], r["max_abs_err"])
            h["ok"] = h["ok"] and r["ok"]

    families, eager_outs = {}, {}
    ops.reset_launch_counts()  # the baselines main-path window starts here
    for name in BASELINES:
        s = sampler(name)
        w = want(evals(s))
        st = compile_cache_stats()
        cold, cold_s, l_cold = run(s, den)
        first = moved(st)
        replays, replay_s = [], []
        for _ in range(BASELINE_REPEATS):
            out, secs, l_r = run(s, den)
            replays.append(out)
            replay_s.append(secs)
            require(l_r == w, f"baselines: {name}: replay launches {l_r}, "
                    f"expected {w}")
        rec: dict = {}
        with held_against_plain(rec):
            ref, eager_s, l_e = run(s, den)
        eager_outs[name] = ref
        hold(rec)
        families[name] = {
            "steps": s.spec.n_steps, "nfe": s.nfe, "evals": evals(s),
            "cold_s": cold_s, "replay_s": spread(replay_s),
            "eager_held_s": eager_s, "first_call_stats": first,
            "launches": {"cold": l_cold, "eager": l_e},
            "held_flash_calls": rec.get("flash_attention", {}).get("calls"),
            "cold_equals_eager_bitwise": bool(torch.equal(cold, ref)),
            "replays_equal_eager_bitwise": all(torch.equal(r, ref)
                                               for r in replays)}
        emit({"phase": "baselines_path", "progress": name, **families[name]})
        require(first == {"hits": 0, "misses": 1, "graphs": 1,
                          "aot_fallbacks": 0},
                f"baselines: {name}: first call {first}")
        require(l_cold == w and l_e == w and evals(s) == s.nfe and
                families[name]["held_flash_calls"] == L * s.nfe,
                f"baselines: {name}: launches {families[name]['launches']}"
                f", held {families[name]['held_flash_calls']}, expected "
                f"{w}")
        require(families[name]["cold_equals_eager_bitwise"] and
                families[name]["replays_equal_eager_bitwise"],
                f"baselines: {name}: replays not bitwise the eager solve")

    # ---- knob sweeps at 20 steps: plan data, one entry and one graph
    st = compile_cache_stats()
    sweep = {f"ddim_eta_{eta}": run(sampler("ddim", eta=eta), den)
             for eta in (0.5, 1.0)}
    sweep["ddim_tau_track"] = run(sampler("ddim", program=StepProgram(
        tau=tuple(1.0 - i / (NFE - 1) for i in range(NFE)))), den)
    sweep_stats = moved(st)
    ddim_w = want(NFE)
    require(sweep_stats == {"hits": 3, "misses": 0, "graphs": 0,
                            "aot_fallbacks": 0} and
            all(l_ == ddim_w for _, _, l_ in sweep.values()),
            f"baselines: ddim sweep {sweep_stats}")
    eta1_is_ancestral = bool(torch.equal(sweep["ddim_eta_1.0"][0],
                                         eager_outs["ddpm_ancestral"]))
    require(eta1_is_ancestral and not torch.equal(
        sweep["ddim_eta_0.5"][0], eager_outs["ddim"]),
            "baselines: ddim at eta 1 is not ddpm_ancestral's solve")

    # ---- edm_stochastic with plain attention against flash
    out_plain, _, l_plain = run(sampler("edm_stochastic"), den_plain)
    require(l_plain["flash_attention"] == 0,
            "baselines: plain-attention solve launched flash")
    plain_gap = rel_gap(eager_outs["edm_stochastic"], out_plain)
    require(plain_gap <= GAP_LIMIT,
            f"baselines: edm_stochastic flash vs plain {plain_gap}")

    # ---- one-call CFG for dpm_solver_pp_2m (class-conditional model)
    dit_c = build_tame_dit_xl2(denoiser_cond=N_CLASSES)
    net_c, _ = tame_networks(dit_c["model"], dit_c["params"], dit_c["mu"])
    den_g = Denoiser(net_c, schedule, prediction="x0", guidance=True,
                     cond_rank=1)
    s_g = sampler("dpm_solver_pp_2m", guidance=True)
    gkw = {"cond": dit_c["cond"], "guidance_scale": CFG_SCALE}
    batches: dict = {}
    with flash_batches(batches):
        g_cold, g_cold_s, l_gc = run(s_g, den_g, x=dit_c["xT"], **gkw)
    g_rep, g_rep_s, l_gr = run(s_g, den_g, x=dit_c["xT"], **gkw)
    rec = {}
    with held_against_plain(rec):
        g_ref, _, _ = run(s_g, den_g, x=dit_c["xT"], **gkw)
    hold(rec)
    guided = {"sampler": repr(s_g.spec), "cold_s": g_cold_s,
              "steady_s": g_rep_s, "flash_calls_by_batch": batches,
              "launches": l_gc,
              "replay_equals_eager_bitwise": bool(torch.equal(g_rep, g_ref)),
              "cold_equals_eager_bitwise": bool(torch.equal(g_cold, g_ref))}
    require(l_gc == l_gr == want(NFE) and
            batches == {2 * SHAPE[0]: L * NFE} and
            guided["replay_equals_eager_bitwise"] and
            guided["cold_equals_eager_bitwise"],
            f"baselines: guided {guided}")

    # ---- the step scheduler at 8 lanes over the conditional model
    den_c = Denoiser(net_c, schedule, prediction="x0")
    served = {}
    for name in SERVED_BASELINES:
        s = sampler(name)
        M = s.spec.n_steps
        prior = schedule.prior_scale(float(s.plan.ts[0]))
        rids = list(range(500, 512))
        joiners = rids[SERVE_LANES:]
        out: dict = {}

        def on_result(r):
            out[r.rid] = r
            if joiners:
                eng.submit(s.spec, REQ_SHAPE, rid=joiners.pop(0))

        eng = ServeEngine(den_c, scheduler="step", lanes=SERVE_LANES,
                          on_result=on_result)
        for rid in rids[:SERVE_LANES]:
            eng.submit(s.spec, REQ_SHAPE, rid=rid)
        tick_s, secs, l_serve, _, sc = launch_window(
            lambda: drive_ticks(eng, sync=True))
        st_e = eng.stats()
        graphs = sc["graphs"]
        gaps = {rid: rel_gap(out[rid].x0, solo_solve(s, den_c, rid, prior))
                for rid in rids}
        served[name] = {
            "requests": len(rids), "lanes": SERVE_LANES,
            "ticks": st_e["ticks"], "joins": st_e["joins"], "seconds": secs,
            "tick_ms": spread([1e3 * t for t in tick_s]),
            "requests_per_s": st_e["requests_per_s"],
            "statuses": sorted({r.status for r in out.values()}),
            "steps": sorted({r.n_steps for r in out.values()}),
            "launches": l_serve, "tick_graphs": graphs,
            "vs_solo_rel_gap_max": max(gaps.values())}
        require(sorted(out) == rids and served[name]["statuses"] == ["ok"]
                and served[name]["steps"] == [M],
                f"baselines: served {name}: {served[name]}")
        # every tick, and the eager tick a capture follows, evaluates the
        # 8-lane batch once (twice for EDM); a replay adds what its
        # capture recorded
        per_tick = 2 if name.startswith("edm") else 1
        require(l_serve == want(per_tick * (st_e["ticks"] + graphs)),
                f"baselines: served {name}: launches {l_serve}, ticks "
                f"{st_e['ticks']}, graphs {graphs}")
        require(served[name]["vs_solo_rel_gap_max"] <= GAP_LIMIT,
                f"baselines: served {name}: vs solo {gaps}")
    state["launches"]["baselines"] = ops.launch_counts()  # window ends
    state["held"]["baselines"] = held
    held_bad = {k: r for k, r in held.items() if not r["ok"]}
    del dit_c, net_c, den_g, den_c

    # ---- the sampling entry point with a baseline and no kernel flag
    argv = ["--arch", "dit-xl-2", "--nfe", str(NFE), "--weights", "tame",
            "--sampler", "edm_heun"]
    printed = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        launch_sample.main(argv)
    entry_s = time.perf_counter() - t
    entry_launches = ops.launch_counts()
    state["launches"]["sample_edm_heun"] = entry_launches
    entry = {"argv": argv, "seconds": entry_s, "launches": entry_launches,
              "printed": printed.getvalue().strip().splitlines(),
              "expected_flash": L * NFE * 2}  # two solves
    result = {"phase": "baselines_path", "arch": model.cfg.name,
              "layers": L, "latent": list(SHAPE), "weights": "tame",
              "nfe": NFE, "repeats": BASELINE_REPEATS,
              "families": families,
              "ddim_sweep": {"stats": sweep_stats,
                             "eta_1_equals_ddpm_ancestral_bitwise":
                                 eta1_is_ancestral},
              "edm_stochastic_flash_vs_plain_rel_gap": plain_gap,
              "gap_limit_f32": GAP_LIMIT, "guided": guided,
              "served": served, "sample_entry_point": entry,
              "held_against_plain": held, "ok": not held_bad}
    emit(result)
    require(not held_bad, f"baselines: kernel calls out of tolerance: "
            f"{held_bad}")
    require(set(held) == set(PATH_KERNELS["baselines"]),
            f"baselines: held calls missing: {held}")
    require(entry_launches["flash_attention"] == entry["expected_flash"] and
            "finite=True" in printed.getvalue(),
            f"baselines: launch.sample's edm_heun run: {entry}")
    return result


def _cache_entries():
    from repro_torch.core.samplers import base
    return list(base._COMPILE_CACHE.values())


#: the feature cache's policies: interval 1 (every step refreshes), 2, 3,
#: and the residual policy at the reference's threshold
FC_POLICIES = {"interval_1": 1, "interval_2": 2, "interval_3": 3,
               "residual_0.05": ("residual", 0.05)}
#: a cached solve's relative deviation from the uncached one (the
#: reference's bar, tests/test_e2e_dit.py)
FC_DEVIATION_LIMIT = 0.05
#: interval 1 against the uncached solve (the reference's bar)
FC_EXACT_LIMIT = 1e-5


def residual_flash(per_reuse: int, per_gate: int, M: int, fires: int) -> int:
    """Flash launches of one ``residual`` solve of M steps: the init
    evaluation and the planned step 0 refresh every layer, each later step
    runs the per_reuse layers outside the cache span, and each of the
    gate's ``fires`` runs the per_gate layers inside it."""
    return 2 * (per_reuse + per_gate) + per_reuse * (M - 1) + per_gate * fires


#: the residual policy's threshold in the feature-cache phases (the
#: reference's, tests/test_e2e_dit.py)
RESIDUAL_FC = ("residual", 0.05)
#: requests a served feature-cache policy takes in ``feature_cache_path``
FC_SERVED = 12


def serve_cached(den, spec, rids, M: int, per_reuse: int,
                 per_gate: int) -> dict:
    """``feature_cache_path``'s step scheduler at SERVE_LANES lanes for one
    feature-cached ``spec``: len(rids) requests, the first SERVE_LANES fill
    the batch (two exit early after 4 steps), the rest join as results come
    in (submitted from ``on_result``), one of them in a second batch that a
    merge migrates. Full-length results against the solve scheduler's
    (buckets of SERVE_LANES: bitwise expected, gated at 1e-4). Records tick
    ms p50/p90 and the share of ticks in which the refresh gate fired (the
    device counter over the served ticks). Launches: a tick counts the
    per_reuse flash calls outside the gate (replays and the eager warm-up
    tick on the empty carry, whose gate never fires); each fire runs
    per_gate more."""
    import torch
    from repro_torch.kernels import graph_gate
    from repro_torch.serve import ServeEngine
    dev = torch.device("cuda", torch.cuda.current_device())
    joiners = list(rids[SERVE_LANES:])
    per_result = [2, 1, 1]
    out: dict = {}

    def on_result(r):
        out[r.rid] = r
        k = per_result.pop(0) if per_result else 0
        for _ in range(min(k, len(joiners))):
            eng.submit(spec, REQ_SHAPE, rid=joiners.pop(0))

    eng = ServeEngine(den, scheduler="step", lanes=SERVE_LANES,
                      on_result=on_result)
    early = set(rids[:2])
    for rid in rids[:SERVE_LANES]:
        eng.submit(spec, REQ_SHAPE, rid=rid,
                   early_exit_tol=1e3 if rid in early else 0.0,
                   min_steps=4 if rid in early else None)
    graph_gate.reset_fires()
    tick_s, secs, launches, _, sc = launch_window(lambda: drive_ticks(eng))
    fires = graph_gate.fires(dev)
    st = eng.stats()
    ref_eng = ServeEngine(den, bucket_sizes=(SERVE_LANES,))
    for rid in rids:
        ref_eng.submit(spec, REQ_SHAPE, rid=rid)
    ref = {r.rid: r for r in ref_eng.run()}
    full = [r for r in rids if r not in early]
    gaps = {r: rel_gap(out[r].x0, ref[r].x0) for r in full}
    counted = per_reuse * (st["ticks"] + sc["graphs"])
    rec = {"requests": len(rids), "lanes": SERVE_LANES, "seconds": secs,
           "ticks": st["ticks"], "tick_ms": spread([1e3 * t
                                                    for t in tick_s]),
           "gate_fires": fires, "gate_fire_share": fires / st["ticks"],
           "requests_per_s": st["requests_per_s"], "joins": st["joins"],
           "migrations": st["migrations"],
           "early_exit_steps": {r: out[r].n_steps for r in sorted(early)},
           "step_cache": sc, "launches": launches,
           "flash_launched": counted + per_gate * fires,
           "vs_solve_scheduler": {
               "rel_gap_max": max(gaps.values()),
               "all_bitwise": all(torch.equal(out[r].x0, ref[r].x0)
                                  for r in full)}}
    require(sorted(out) == sorted(rids) and
            all(out[r].status == "ok" for r in rids) and
            all(out[r].n_steps == M for r in full) and
            all(n == 4 for n in rec["early_exit_steps"].values()) and
            st["migrations"] >= 1,
            f"fc: served {spec.feature_cache}: {sorted(out)}, "
            f"{rec['early_exit_steps']}, migrations {st['migrations']}")
    require(launches["flash_attention"] == counted and
            launches["sa_fused"] == st["ticks"] + sc["graphs"] and
            0 < fires <= st["ticks"],
            f"fc: served {spec.feature_cache}: launches {launches}, "
            f"ticks {st['ticks']}, graphs {sc['graphs']}, fires {fires}")
    require(rec["vs_solve_scheduler"]["rel_gap_max"] <= GAP_LIMIT,
            f"fc: served {spec.feature_cache} vs the solve scheduler: "
            f"{gaps}")
    return rec


def phase_feature_cache_path(state: dict) -> dict:
    """DeepCache feature caching over the main path's unconditional
    DiT-XL/2 (cache span (4, 24) of 28 layers): SA NFE 20 P3C3 PEC tau 1,
    fused f32, flash, the phase's own x_T and noise.

    - ``sample()``: each policy of ``FC_POLICIES`` and the uncached solve,
      cold (an eager warm-up and the capture) and steady (a replay); r
      refreshing steps = the planned ones + the residual gate's fires (a
      device counter); counted flash launches exactly 28 + 28 r + 8 (19 -
      r) for an eager solve (the wrapper's refresh flags agree), and the
      gate's 20 a fire fewer for a replay. Interval 1 within 1e-5 of the
      uncached solve, the others within 0.05 (both the reference's
      bars). One guided + cached solve (interval 2, a shared (seq, dz)
      input-space prompt, scale 1.5: the features carry the doubled
      batch) against the guided uncached solve; one interval-2 solve held
      against the plain versions.
    - ``sample_batched`` of the 8 latents as 8 lanes under
      ``residual:0.05``: cold, replay and ``eager()`` bitwise; each lane
      against its solo ``sample()`` (gate 1e-4); the per-lane refresh
      counts of the eager solve ([8] device masks).
    - ``ServeEngine`` at 8 lanes under the step scheduler, FC_SERVED
      requests under interval 2 and FC_SERVED under ``residual:0.05``
      (``serve_cached``)."""
    import torch
    from repro_torch.core import CachedNetwork, Denoiser, make_sampler
    from repro_torch.core.samplers import eager
    from repro_torch.kernels import graph_gate, ops
    from repro_torch.models.tame import tame_networks
    dev = torch.device("cuda")
    model, params, mu, schedule = _tame_dit_xl2(state, last_user=True)
    L = model.cfg.n_layers
    a, b = model.cache_span()
    net, cached = tame_networks(model, params, mu)
    refreshes: list = []

    def call(x, t, c, feats, refresh):
        if not torch.cuda.is_current_stream_capturing():
            refreshes.append(refresh if isinstance(refresh, bool)
                             else refresh.clone())
        return cached.call(x, t, c, feats, refresh)

    counted = CachedNetwork(call=call, init=cached.init)
    g = torch.Generator(dev).manual_seed(41)
    s0 = make_sampler("sa", nfe=NFE, schedule=schedule)
    xT = s0.init_noise(g, SHAPE)
    xis = [torch.randn(SHAPE, generator=g, device=dev)
           for _ in range(s0.spec.n_steps)]
    prompt = 0.1 * torch.randn(SHAPE[1:], generator=g, device=dev)

    def sampler(fc, guided=False):
        return make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                            corrector_order=3, mode="PEC", combine="fused",
                            schedule=schedule, prediction="x0",
                            guidance=guided, feature_cache=fc)

    def flash_per_solve(r, M):
        return L + L * r + (L - (b - a)) * (M - r)

    def solve(label, fc, guided=False):
        s = sampler(fc, guided)
        M = s.spec.n_steps
        den = Denoiser(net, schedule, prediction="x0", guidance=guided,
                       cached=counted if fc is not None else None)
        kw = {"cond": prompt, "guidance_scale": CFG_SCALE} if guided else {}
        planned = M if fc is None else sum(s.plan.arrays["fc_refresh"])
        rec, outs = {"steps": M}, []
        for kind in ("cold", "steady"):
            refreshes.clear()
            graph_gate.reset_fires()
            out, secs, launches, batches, ran_eager = _timed_solve(
                s, den, xT, xis, **kw)
            fires = graph_gate.fires(dev)
            r = planned + fires
            require(ran_eager or not refreshes,
                    f"fc: {label}: a replay ran the cached network's Python")
            if ran_eager and fc is not None:  # the flags the calls saw
                seen = sum(bool(f) for f in refreshes) - 1  # the init
                require(seen == r, f"fc: {label}: {seen} refreshing steps "
                        f"seen, {planned} planned + {fires} gated")
            flash = flash_per_solve(r, M) - (0 if ran_eager
                                             else (b - a) * fires)
            want = {"sa_fused": M, "sa_update": 0, "rwkv6_wkv": 0,
                    "flash_attention": flash}
            batch = 2 * SHAPE[0] if guided else SHAPE[0]
            require(launches == want and set(batches) == (
                        {batch} if ran_eager else set()),
                    f"fc: {label}: launches {launches} at batches {batches}, "
                    f"expected {want} at {batch}")
            rec |= {f"{kind}_s": secs, "refreshing_steps": r,
                    "gate_fires": fires, "launches": launches,
                    "flash_launched": flash_per_solve(r, M),
                    "flash_calls_by_batch": batches}
            outs.append(out)
        rec["repeat_bitwise"] = bool(torch.equal(*outs))
        return outs[0], rec

    ops.reset_launch_counts()  # the feature-cache main-path window starts
    runs, outs = {}, {}
    for label, fc in {"uncached": None, **FC_POLICIES}.items():
        outs[label], runs[label] = solve(label, fc)
    outs["guided_uncached"], runs["guided_uncached"] = solve(
        "guided_uncached", None, guided=True)
    outs["guided_interval_2"], runs["guided_interval_2"] = solve(
        "guided_interval_2", 2, guided=True)

    # ---- sample_batched: the 8 latents as 8 lanes under residual:0.05
    s_res = sampler(RESIDUAL_FC)
    M = s_res.spec.n_steps
    den_c = Denoiser(net, schedule, prediction="x0", cached=counted)
    lane_noise = torch.stack(xis, dim=1)  # [8, M, 256, 16]

    def batched():
        refreshes.clear()
        graph_gate.reset_fires()
        out = s_res.sample_batched(den_c, xT, noise=lane_noise)
        torch.cuda.synchronize()
        return out, graph_gate.fires(dev), [
            f for f in refreshes if isinstance(f, torch.Tensor)]

    (cold, f_cold, _), cold_s, l_cold, _, _ = launch_window(batched)
    (replay, f_replay, m_replay), replay_s, l_replay, _, _ = launch_window(
        batched)
    with eager():
        (ref, f_eager, masks), eager_s, l_eager, _, _ = launch_window(
            batched)
    per_reuse, per_gate = L - (b - a), b - a
    lane_refresh = (1 + torch.stack(masks).sum(0)).tolist()
    lane_gaps = {}
    for k in range(SHAPE[0]):
        solo = s_res.sample(den_c, xT[k:k + 1],
                            noise=lane_noise[k][:, None])[0]
        lane_gaps[k] = rel_gap(ref[k], solo)
    runs["batched_residual_0.05"] = {
        "lanes": SHAPE[0], "steps": M, "cold_s": cold_s,
        "replay_s": replay_s, "eager_s": eager_s,
        "cold_equals_eager_bitwise": bool(torch.equal(cold, ref)),
        "replay_equals_eager_bitwise": bool(torch.equal(replay, ref)),
        "gate_fires": {"cold": f_cold, "replay": f_replay,
                       "eager": f_eager},
        "refreshing_steps_by_lane": lane_refresh,
        "flash_launches": {"cold": l_cold["flash_attention"],
                           "replay": l_replay["flash_attention"],
                           "eager": l_eager["flash_attention"]},
        "vs_solo_rel_gap": lane_gaps}
    rb = runs["batched_residual_0.05"]
    require(rb["cold_equals_eager_bitwise"] and
            rb["replay_equals_eager_bitwise"] and not m_replay and
            f_cold == f_replay == f_eager == len(masks) - sum(
                not bool(m.any()) for m in masks),
            f"fc: batched residual: {rb}")
    require(rb["flash_launches"] == {
                "cold": residual_flash(per_reuse, per_gate, M, f_eager),
                "replay": residual_flash(per_reuse, per_gate, M, 0),
                "eager": residual_flash(per_reuse, per_gate, M, f_eager)},
            f"fc: batched residual launches {rb['flash_launches']}")
    require(max(lane_gaps.values()) <= GAP_LIMIT,
            f"fc: batched residual lanes vs solo: {lane_gaps}")

    # ---- served: the step scheduler at 8 lanes, interval 2 and residual
    den_s = Denoiser(net, schedule, prediction="x0", cached=cached)
    served = {}
    for i, (label, fc) in enumerate((("interval_2", 2),
                                     ("residual_0.05", RESIDUAL_FC))):
        rids = list(range(500 + 100 * i, 500 + 100 * i + FC_SERVED))
        served[label] = serve_cached(den_s, sampler(fc).spec, rids, M,
                                     per_reuse, per_gate)
        emit({"phase": "feature_cache_path", "progress": label,
              **served[label]})

    held: dict = {}
    with held_against_plain(held):
        solve("held_interval_2", 2)
    state["launches"]["feature_cache"] = ops.launch_counts()  # window ends
    state["held"]["feature_cache"] = held

    ref = outs["uncached"]
    deviation = {label: rel_gap(outs[label], ref) for label in FC_POLICIES}
    deviation["guided_interval_2"] = rel_gap(outs["guided_interval_2"],
                                             outs["guided_uncached"])
    bad = {k: d for k, d in deviation.items() if not d < FC_DEVIATION_LIMIT}
    if not deviation["interval_1"] <= FC_EXACT_LIMIT:
        bad["interval_1"] = deviation["interval_1"]
    steady = runs["uncached"]["steady_s"]
    layer_s = steady / flash_per_solve(NFE - 1, NFE - 1)
    for label in FC_POLICIES:
        r = runs[label]
        r["layer_evaluations"] = r["flash_launched"]
        r["steady_vs_uncached"] = r["steady_s"] / steady
        r["predicted_by_layers_s"] = r["layer_evaluations"] * layer_s
    held_bad = {k: r for k, r in held.items() if not r["ok"]}
    result = {"phase": "feature_cache_path", "arch": model.cfg.name,
              "layers": L, "cache_span": [a, b], "latent": list(SHAPE),
              "weights": "tame", "nfe": NFE, "policies": {
                  k: repr(v) for k, v in FC_POLICIES.items()},
              "runs": runs, "served": served,
              "rel_deviation_from_uncached": deviation,
              "deviation_limit": FC_DEVIATION_LIMIT,
              "interval_1_limit": FC_EXACT_LIMIT,
              "held_against_plain": held,
              "ok": not bad and not held_bad}
    emit(result)
    require(not bad, f"fc: deviations out of bounds: {bad}")
    require(not held_bad, f"fc: kernel calls out of tolerance: {held_bad}")
    require(set(held) == set(PATH_KERNELS["feature_cache"]),
            f"fc: held calls missing: {held}")
    return result


#: replays of the sharded solve timed in ``sharded_path`` (p50/p90)
SHARD_REPLAYS = 5
#: seconds the two cfg ranks of ``sharded_path`` may take, start to end
SHARD_RANKS_DEADLINE_S = 300


def _sharded_inputs(dev, M: int, seed: int = 11):
    """The sharded phase's step noise [8, M, 256, 16] and one-hot classes
    [8, N_CLASSES] (one generator, seeded ``seed``)."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    noise = torch.randn((SHAPE[0], M) + REQ_SHAPE, generator=g, device=dev)
    classes = torch.randint(0, N_CLASSES, (SHAPE[0],), generator=g,
                            device=dev)
    return noise, torch.nn.functional.one_hot(classes, N_CLASSES).float()


def _sharded_model(dit: dict, guided: bool):
    """(sampler, Denoiser) of the sharded phase over ``dit``, the
    class-conditional tame DiT-XL/2: SA NFE 20 P3C3 PEC tau 1, fused."""
    from repro_torch.core import Denoiser, make_sampler
    from repro_torch.models.tame import tame_networks
    net, _ = tame_networks(dit["model"], dit["params"], dit["mu"])
    den = Denoiser(net, dit["schedule"], prediction="x0", guidance=guided,
                   cond_rank=1 if guided else None)
    s = make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                     corrector_order=3, mode="PEC", combine="fused",
                     schedule=dit["schedule"], prediction="x0",
                     guidance=guided)
    return s, den


def sharded_cfg_rank(rank: int, workdir: str) -> int:
    """One of ``sharded_path``'s two cfg ranks (``chip_smoke.py --cfg-rank
    RANK DIR``): a gloo group of two on the one card, a (cfg=2, data=1)
    mesh, one eager guided solve of the phase's inputs through
    ``sample_sharded``; writes its output, launches and flash calls by
    batch to ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.samplers import compile_cache_stats
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/gloo",
                            rank=rank, world_size=2)
    try:
        mesh = make_test_mesh((2, 1), ("cfg", "data"), device="cuda")
        s, den = _sharded_model(build_tame_dit_xl2(N_CLASSES), guided=True)
        inp = {k: v.cuda() for k, v in torch.load(
            os.path.join(workdir, "inputs.pt")).items()}
        ops.reset_launch_counts()
        batches: dict = {}
        with flash_batches(batches):
            t = time.perf_counter()
            out = s.sample_sharded(den, inp["xT"], noise=inp["noise"],
                                   cond=inp["cond"], mesh=mesh,
                                   cfg_axis="cfg", guidance_scale=CFG_SCALE)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        launches = ops.launch_counts()
        cfg = mesh.get_group("cfg")
        torch.save({"out": out.cpu(), "seconds": secs, "launches": launches,
                    "flash_calls_by_batch": batches,
                    # the port hands gloo the CUDA tensors (no host copy of
                    # its own; what gloo stages inside is not seen here)
                    "exchange": f"{dist.get_backend(cfg)} all_gather of "
                                f"{out.device} tensors",
                    "cfg_rank": dist.get_rank(cfg),
                    "eager_entries": compile_cache_stats()["eager_entries"],
                    "graphs": compile_cache_stats()["graphs"]},
                   os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _run_ranks(flag: str, workdir: str, deadline_s: float,
               what: str) -> list:
    """Start two ranks (``chip_smoke.py FLAG RANK DIR``), each in a session
    of its own; kill both at the deadline; their results."""
    import torch
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, str(r),
         workdir], start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            os.killpg(p.pid, 9)
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    require(not late, f"{what} ranks past {deadline_s} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0,
                f"{what} rank {r} exited {p.returncode}: {log[-2000:]}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"))
            for r in range(2)]


def phase_sharded_path(state: dict) -> dict:
    """The port's sharded path (``sample_sharded``, ``ServeEngine(mesh=)``,
    ``launch.sample --cfg-shard``, sharded CFG) over ``torch.distributed``
    at DiT-XL/2 full width: the class-conditional tame DiT-XL/2, latent
    [8, 256, 16], SA NFE 20 P3C3 PEC tau 1, fused f32, flash. One card
    runs the sharded path at one NCCL rank; two ranks share it only under
    gloo (NCCL refuses two ranks on one device). No speed is claimed.

    1. An NCCL group of one rank (a ``file://`` store; one collective
       before any capture), a (data=1, model=1) mesh: ``sample_sharded``
       of the 8 lanes, a cold call and SHARD_REPLAYS replays (p50/p90),
       each bitwise the ``sample_batched`` replay of the same lanes and
       noise; one eager call with every kernel call held against its
       plain version.
    2. ``ServeEngine(mesh=)``, solve scheduler, buckets (1, 2, 4, 8): 8
       plus a ragged 3 requests, bitwise the unsharded engine's results.
       Each engine's bucket of 8 is an entry of step 1 (a hit: the
       sharded one keyed by the mesh), its bucket of 4 a new entry and
       graph of its own.
    3. ``launch.sample --cfg-shard`` refuses at one rank.
    4. Two gloo ranks on the card (``--cfg-rank``), a (cfg=2, data=1)
       mesh, CFG at 1.5, eager (a cfg-sharded entry is not captured):
       each rank evaluates one branch at batch 8 (560 flash calls), the
       halves exchanged by gloo's ``all_gather`` of the CUDA tensors; the
       output against the one-call CFG ``sample_batched`` (batch 16) at
       GAP_LIMIT, both ranks' outputs bitwise equal.

    The unsharded twins of 1 and 2 (the ``sample_batched`` capture and
    replay, the unsharded engine's 3 solves) run first, and their launches
    are recorded apart (``unsharded_twins_launches``). The sharded launch
    window then covers 1-2 in this process (the sharded solves only), and
    4's ranks add their own counts."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.core.samplers import (compile_cache_stats,
                                           sample_batched, sample_sharded)
    from repro_torch.kernels import ops
    from repro_torch.launch import sample as launch_sample
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve import ServeEngine
    dev = torch.device("cuda")
    dit = build_tame_dit_xl2(denoiser_cond=N_CLASSES)
    s, den = _sharded_model(dit, guided=False)
    L, M = dit["model"].cfg.n_layers, s.spec.n_steps
    xT = dit["xT"]
    noise, cond = _sharded_inputs(dev, M)
    per_solve = only_launches(flash_attention=L * NFE, sa_fused=M)

    def solves(n):
        return {k: n * v for k, v in per_solve.items()}

    res: dict = {}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{workdir}/nccl",
                            rank=0, world_size=1)
    try:
        warm = torch.ones(1, device=dev)
        dist.all_reduce(warm)  # NCCL's communicator, before any capture
        torch.cuda.synchronize()
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")

        def batched():
            return sample_batched(s.plan, den, xT, noise=noise)

        def sharded():
            return sample_sharded(s.plan, den, xT, noise=noise, mesh=mesh)

        def serve(mesh_):
            eng = ServeEngine(den, bucket_sizes=(1, 2, 4, 8), mesh=mesh_)
            for rid in range(11):
                eng.submit(s.spec, REQ_SHAPE, rid=rid)
            out, secs, lw, cw, _ = launch_window(
                lambda: {r.rid: r for r in eng.run()})
            return out, secs, lw, cw, eng.stats()

        # ---- the unsharded twins that 1 and 2 are held against (their
        # launches are recorded apart, outside the sharded window)
        ops.reset_launch_counts()
        batched()  # the unsharded entry's capture
        ref, _, l_ref, c_ref, _ = launch_window(batched)
        require(l_ref == solves(1) and c_ref["graphs"] == 0,
                f"sharded: the sample_batched replay: {l_ref} {c_ref}")
        plain, plain_s, l_plain, c_plain, st_plain = serve(None)
        twins = ops.launch_counts()
        ops.reset_launch_counts()  # the sharded main-path window starts here

        # ---- 1. sample_sharded on the size-1 NCCL mesh
        cold, cold_s, l_cold, c_cold, _ = launch_window(sharded)
        require(l_cold == solves(1) and c_cold["misses"] == 1 and
                c_cold["graphs"] == 1,
                f"sharded: cold sample_sharded: {l_cold} {c_cold}")
        replays, bitwise = [], [torch.equal(cold, ref)]
        for _ in range(SHARD_REPLAYS):
            out, secs, l_rep, c_rep, _ = launch_window(sharded)
            require(l_rep == solves(1) and c_rep["graphs"] == 0,
                    f"sharded: a replay: {l_rep} {c_rep}")
            replays.append(secs)
            bitwise.append(torch.equal(out, ref))
        held: dict = {}
        with held_against_plain(held):
            held_out = sharded()
        res["nccl_1_rank"] = {
            "mesh": {"shape": [1, 1], "axes": ["data", "model"],
                     "backend": dist.get_backend()},
            "cold_s": cold_s, "replay_s": spread(replays),
            "bitwise_sample_batched_replay": bitwise,
            "held_eager_rel_gap": rel_gap(held_out, ref),
            "launches_per_solve": per_solve,
            "unsharded_twins_launches": twins}
        require(all(bitwise), f"sharded: not bitwise sample_batched: "
                f"{bitwise}")
        require(rel_gap(held_out, ref) <= GAP_LIMIT,
                f"sharded: held eager solve {rel_gap(held_out, ref)}")

        # ---- 2. the engine on the mesh against the unsharded engine
        shard, shard_s, l_shard, c_shard, st_shard = serve(mesh)
        same = {rid: shard[rid].status == "ok" and
                torch.equal(shard[rid].x0, plain[rid].x0) for rid in plain}
        res["engine"] = {
            "requests": 11, "buckets": [1, 2, 4, 8],
            "serve_s": {"unsharded": plain_s, "sharded": shard_s},
            "padded_slots": st_shard["padded_slots"],
            "microbatches": st_shard["microbatches"],
            "cache_delta": {"unsharded": c_plain, "sharded": c_shard},
            "launches": {"unsharded": l_plain, "sharded": l_shard},
            "bitwise_unsharded": same,
            "compile_cache": compile_cache_stats()}
        require(all(same.values()), f"sharded engine: not bitwise {same}")
        require(st_shard["microbatches"] == 2 and
                st_shard["padded_slots"] == 1 and
                c_plain["misses"] == c_shard["misses"] == 1 and
                c_plain["graphs"] == c_shard["graphs"] == 1 and
                l_plain == l_shard == solves(3),
                f"sharded engine: {res['engine']}")

        # ---- 3. --cfg-shard at one rank
        try:
            launch_sample.main(["--arch", "dit-xl-2", "--guidance-scale",
                                str(CFG_SCALE), "--cfg-shard"])
            refusal = None
        except SystemExit as e:
            refusal = str(e)
        res["cfg_shard_refusal"] = refusal
        require(refusal == "--cfg-shard needs an even device count >= 2 "
                "(have 1)", f"sharded: --cfg-shard at one rank: {refusal}")
    finally:
        dist.destroy_process_group()
    launches = ops.launch_counts()  # this process's window ends

    # ---- 4. two gloo ranks on the one card, CFG at 1.5
    s_g, den_g = _sharded_model(dit, guided=True)
    one_call = sample_batched(s_g.plan, den_g, xT, noise=noise, cond=cond,
                              guidance_scale=CFG_SCALE)
    torch.save({"xT": xT.cpu(), "noise": noise.cpu(), "cond": cond.cpu()},
               os.path.join(workdir, "inputs.pt"))
    t = time.perf_counter()
    ranks = _run_ranks("--cfg-rank", workdir, SHARD_RANKS_DEADLINE_S,
                       "sharded: cfg")
    ranks_s = time.perf_counter() - t
    shutil.rmtree(workdir, ignore_errors=True)
    for r in ranks:
        launches = {k: launches[k] + r["launches"][k] for k in launches}
    gaps = [rel_gap(r["out"].to(dev), one_call) for r in ranks]
    res["cfg_2_ranks"] = {
        "mesh": {"shape": [2, 1], "axes": ["cfg", "data"],
                 "backend": "gloo", "device": "cuda:0 (both ranks)"},
        "guidance_scale": CFG_SCALE, "wall_s": ranks_s,
        "ranks": [{k: r[k] for k in ("cfg_rank", "seconds", "launches",
                                     "flash_calls_by_batch", "exchange",
                                     "eager_entries", "graphs")}
                  for r in ranks],
        "vs_one_call_rel_gap": gaps,
        "ranks_bitwise": torch.equal(ranks[0]["out"], ranks[1]["out"])}
    state["launches"]["sharded"] = launches
    state["held"]["sharded"] = held
    held_bad = {k: h for k, h in held.items() if not h["ok"]}
    result = {"phase": "sharded_path", "arch": dit["model"].cfg.name,
              "layers": L, "d_model": dit["model"].cfg.d_model,
              "denoiser_cond": N_CLASSES, "latent": list(SHAPE),
              "weights": "tame",
              "sampler": {"name": "sa", "nfe": NFE, "tau": 1.0,
                          "predictor_order": 3, "corrector_order": 3,
                          "mode": "PEC", "combine": "fused"},
              "gap_limit_f32": GAP_LIMIT, **res, "launches": launches,
              "held_against_plain": held, "ok": not held_bad}
    emit(result)
    require(not held_bad, f"sharded: kernel calls out of tolerance: "
            f"{held_bad}")
    require(set(held) == set(PATH_KERNELS["sharded"]),
            f"sharded: held calls missing: {held}")
    require(max(gaps) <= GAP_LIMIT and res["cfg_2_ranks"]["ranks_bitwise"],
            f"sharded CFG: gaps {gaps}, ranks bitwise "
            f"{res['cfg_2_ranks']['ranks_bitwise']}")
    for r in ranks:
        require(r["flash_calls_by_batch"] == {SHAPE[0]: L * NFE} and
                r["launches"]["sa_fused"] == M and
                r["eager_entries"] == 1 and r["graphs"] == 0,
                f"sharded CFG rank {r['cfg_rank']}: {r}")
    return result


# parallel_path: the distribution layer over two gloo ranks on the card
PAR_ARCH = "starcoder2-3b"
PAR_LAYERS = 4
PAR_BATCH = 8       # global: 4 host rows a rank
PAR_SEQ = 128
PAR_STEPS = 3
PAR_LR = 3e-5
#: the strategies trained on the card's two gloo ranks. ``tp`` places
#: like ``dp`` on a (data=2) mesh (no ``model`` axis). ``fsdp_tp`` and
#: ``serve_2d`` shard leaves over data, and DTensor's Shard -> Replicate
#: redistribution of a CUDA tensor over gloo (its functional
#: all_gather_into_tensor) kills the process with SIGSEGV on the card's
#: PyTorch 2.11 (dist.all_gather_into_tensor itself works): they train
#: on the CPU's gloo ranks (tests/test_torch_train_ranks.py)
PAR_STRATEGIES = ("dp",)
#: the reference test's loss bar (tests/test_parallel.py)
PAR_LOSS_LIMIT = 2e-4
#: each parameter leaf after the steps: |got - one process| <= limit x
#: max(1, max|leaf|) (the kernel bars' form)
PAR_PARAM_LIMIT = 1e-5
#: each leaf's change over the steps against the one process's change:
#: max|delta got - delta one process| <= limit x max|delta one process|.
#: The warm-up's three steps (LR 0, 3e-6, 6e-6) move an element ~9e-6,
#: under PAR_PARAM_LIMIT's bar; here a step that applied no update is
#: 1.0 off (at most 0.012 on the CPU's ranks, tests/test_torch_train_ranks)
PAR_MOVE_LIMIT = 0.05
#: compressed_psum against the exact all-reduce (the reference's bar)
PAR_PSUM_LIMIT = 0.02
PIPE_STAGES = 2
PIPE_MICRO = 4
PIPE_MB = 2
#: each microbatch's diffusion time (its adaLN conditioning)
PIPE_TS = (0.9, 0.7, 0.5, 0.3)
PAR_RANKS_DEADLINE_S = 420


def _par_say(what: str) -> None:
    """A rank's progress line (its log is shown when it fails)."""
    import torch.distributed as dist
    print(f"parallel rank {dist.get_rank()}: {what}", flush=True)


def _par_global_batch(task, step: int, dev) -> dict:
    """The two hosts' ``synthetic_lm_batch`` rows of ``step`` concatenated
    in rank order: the global batch of the (data=2) mesh."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic_lm_batch
    parts = [synthetic_lm_batch(task, PAR_BATCH // 2, step, h)
             for h in range(2)]
    return {k: torch.as_tensor(np.concatenate([p[k] for p in parts]),
                               device=dev) for k in parts[0]}


def _par_training(mesh) -> dict:
    """starcoder2-3b at published width, ``PAR_LAYERS`` layers, on a
    float32 stream (as ``lm_train_path``'s 4-layer checks: on the
    published bfloat16 stream, batches of 4 and 8 rows round apart by
    ~2e-4 in the loss), tempered (``_temper_lm``): ``PAR_STEPS`` steps of ``launch.train``'s step in one
    process over the global batches, then under each of PAR_STRATEGIES
    over the (data=2) mesh (DTensor parameters by ``specs_for``, batches
    sharded over data, inside ``activation_sharding``); per step the
    losses, and after the steps every parameter leaf and its change over
    the steps (PAR_MOVE_LIMIT), against the one process. Then ``compressed_psum`` of this rank's gradient tree across
    the two ranks against the exact all-reduce."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data import TokenTaskConfig
    from repro_torch.launch import train as lt
    from repro_torch.models import build_model, init_params
    from repro_torch.models.common import (activation_sharding,
                                           distribute_tree, specs_for)
    from repro_torch.parallel import compressed_psum
    from repro_torch.tree import paths_and_leaves, tree_leaves
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(PAR_ARCH), n_layers=PAR_LAYERS,
                              dtype=torch.float32)
    model = build_model(lt.train_config(cfg))
    task = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=PAR_SEQ)
    opt = lt.make_optimizer(PAR_LR, PAR_STEPS)

    def tempered():
        return _temper_lm(init_params(torch.Generator(dev).manual_seed(0),
                                      model.param_defs(), torch.float32))

    def state_of(params):
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    init = dict(paths_and_leaves(tempered()))
    # one process over the global batches
    _par_say("one process")
    st, step = state_of(tempered()), lt.make_train_step(model, opt)
    ref_losses, ref_s = [], []
    for k in range(PAR_STEPS):
        t = time.perf_counter()
        st, m = step(st, _par_global_batch(task, k, dev))
        ref_losses.append(float(m["loss"]))
        ref_s.append(time.perf_counter() - t)
    ref = dict(paths_and_leaves(st["params"]))
    del st
    out: dict = {"arch": PAR_ARCH, "layers": PAR_LAYERS, "stream": "float32",
                 "global_batch": [PAR_BATCH, PAR_SEQ], "lr": PAR_LR,
                 "params": sum(v.numel() for v in ref.values()),
                 "one_process": {"losses": ref_losses, "step_s": ref_s}}
    for strategy in PAR_STRATEGIES:
        _par_say(strategy)
        specs = specs_for(model.param_defs(), strategy, mesh)
        st = state_of(distribute_tree(tempered(), specs, mesh))
        step = lt.make_train_step(model, opt, mesh)
        batches = lt.make_batches(cfg, PAR_BATCH, PAR_SEQ, dev, mesh)
        losses, secs = [], []
        with activation_sharding(("data",)):
            for _ in range(PAR_STEPS):
                t = time.perf_counter()
                st, m = step(st, next(batches))
                losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
        worst, worst_rel, placed = 0.0, 0.0, 0
        move_err, moved_min = 0.0, float("inf")
        for k, v in paths_and_leaves(st["params"]):
            placed += any(p.is_shard() for p in v.placements)
            full, want = v.full_tensor(), ref[k]
            err = float((full - want).abs().max())
            peak = float(want.abs().max())
            worst = max(worst, err / max(1.0, peak))
            worst_rel = max(worst_rel, err / peak if peak else 0.0)
            moved = want - init[k]
            moved_peak = float(moved.abs().max())
            off = float((full - init[k] - moved).abs().max())
            moved_min = min(moved_min, moved_peak)
            move_err = max(move_err, off / moved_peak if moved_peak
                           else float("inf"))
            del full, moved
        gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
        require(max(gaps) <= PAR_LOSS_LIMIT,
                f"parallel: {strategy} losses {losses} vs {ref_losses}")
        require(worst <= PAR_PARAM_LIMIT,
                f"parallel: {strategy} parameters {worst} from one process")
        require(move_err <= PAR_MOVE_LIMIT,
                f"parallel: {strategy} updates {move_err} from one process's "
                f"(least leaf movement {moved_min})")
        out[strategy] = {"losses": losses, "loss_gaps": gaps,
                         "param_err": worst, "param_err_of_leaf": worst_rel,
                         "update_err": move_err,
                         "least_leaf_movement": moved_min,
                         "sharded_leaves": placed, "step_s": secs}
        del st, batches
        gc.collect()
        torch.cuda.empty_cache()

    # compressed_psum of this rank's gradients (its host rows, step 0)
    _par_say("compressed_psum")
    host = {k: v[dist.get_rank() * (PAR_BATCH // 2):][:PAR_BATCH // 2]
            for k, v in _par_global_batch(task, 0, dev).items()}
    _, grads = lt.loss_and_grads(model, tempered(), host)
    worst, f32_bytes, n = 0.0, 0, 0
    t = time.perf_counter()
    for g in tree_leaves(grads):
        got = compressed_psum(g)
        exact = g.clone()
        dist.all_reduce(exact)
        worst = max(worst, float((got - exact).abs().max())
                    / max(float(exact.abs().max()), 1e-30))
        f32_bytes += 4 * g.numel()
        n += g.numel()
    secs = time.perf_counter() - t
    require(worst <= PAR_PSUM_LIMIT,
            f"parallel: compressed_psum {worst} from the exact all-reduce")
    out["compressed_psum"] = {
        "max_rel_err": worst, "leaves": len(tree_leaves(grads)),
        "int8_bytes": n, "f32_bytes": f32_bytes,
        "wire": "int32 sums (the reference's psum of int32), gloo",
        "both_reductions_s": secs}
    return out


def _par_pipeline(mesh) -> dict:
    """The tame DiT-XL/2's 28 blocks as PIPE_STAGES stages of 14 over the
    ranks of ``mesh``'s ``stage`` axis: PIPE_MICRO microbatches of
    [PIPE_MB, 256, 1152] (each with its own time's adaLN conditioning,
    which travels with it), every flash call held against its plain
    version, against the 28 blocks on this rank alone."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.common import unstack
    from repro_torch.models.tame import tame_dit
    from repro_torch.parallel import pipeline_apply
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    _par_say("pipeline")
    model, params, _ = tame_dit("dit-xl-2", smoke=False, seed=0,
                                use_flash=True, device=dev)
    L = model.cfg.n_layers
    stage_params = tree_map(lambda v: v.reshape(
        PIPE_STAGES, L // PIPE_STAGES, *v.shape[1:]), params["blocks"])
    g = torch.Generator(dev).manual_seed(31)
    z = torch.randn((PIPE_MICRO, PIPE_MB) + REQ_SHAPE, generator=g,
                    device=dev)
    with torch.no_grad():
        embedded = [model._denoise_embed(params["denoiser"], z[i], t, None)
                    for i, t in enumerate(PIPE_TS)]
        x_micro = {"x": torch.stack([e[0] for e in embedded]),
                   "c": torch.stack([e[1] for e in embedded])}

        def block_fn(p, xc):
            h = xc["x"]
            for layer in unstack(p):
                h = model._block(layer, h, xc["c"])
            return {"x": h, "c": xc["c"]}

        held: dict = {}
        ops.reset_launch_counts()
        with held_against_plain(held):
            t = time.perf_counter()
            out = pipeline_apply(block_fn, stage_params, x_micro, mesh)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        launches = ops.launch_counts()
        layers = model._layers(params)
        ref = torch.stack([model._stack(layers, x_micro["x"][i],
                                        x_micro["c"][i], 0, L)
                           for i in range(PIPE_MICRO)])
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    gap = float((out["x"] - ref).abs().max() / ref.abs().max())
    require(gap <= GAP_LIMIT,
            f"parallel: pipeline {gap} of the peak from one rank")
    require(torch.equal(out["c"], x_micro["c"]),
            "parallel: the conditioning came back changed")
    want = ticks * (L // PIPE_STAGES)
    require(launches["flash_attention"] == want,
            f"parallel: pipeline flash launches {launches} (want {want})")
    require(held["flash_attention"]["ok"],
            f"parallel: pipeline flash held {held}")
    return {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
            "microbatch": [PIPE_MB, REQ_SHAPE[0], model.cfg.d_model],
            "ticks": ticks, "gap": gap, "seconds": secs,
            "launches": launches, "held": held}


def parallel_rank(rank: int, workdir: str) -> int:
    """One of ``parallel_path``'s two ranks (``chip_smoke.py
    --parallel-rank RANK DIR``): a gloo group of two on the one card
    (``file://`` store), the training and compression checks on a
    (data=2) mesh, the pipeline on a (stage=2) mesh; writes its results
    to ``DIR/rank{RANK}.pt``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/gloo",
                            rank=rank, world_size=2)
    try:
        t = time.perf_counter()
        out = {"training": _par_training(
            make_test_mesh((2,), ("data",), device="cuda"))}
        out["training"]["seconds"] = time.perf_counter() - t
        out["pipeline"] = _par_pipeline(
            make_test_mesh((PIPE_STAGES,), ("stage",), device="cuda"))
        out["backend"] = dist.get_backend()
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def phase_parallel_path(state: dict) -> dict:
    """The distribution layer (``models.common``'s specs and activation
    pins, ``parallel/``, ``launch.train`` over ranks) on the card, and the
    two thin examples. Two gloo ranks share the card (NCCL refuses two
    ranks on one device), as ``sharded_path``'s cfg ranks do; no speed is
    claimed (two ranks on one card say nothing about many cards).

    1. ``parallel_rank`` x 2: starcoder2-3b training under PAR_STRATEGIES
       against one process (losses within PAR_LOSS_LIMIT a step, each
       parameter leaf within PAR_PARAM_LIMIT), ``compressed_psum`` of the
       gradients within PAR_PSUM_LIMIT of the exact all-reduce, the
       DiT-XL/2 pipeline within GAP_LIMIT of one rank, its flash calls
       held and counted.
    2. ``examples/torch_quickstart.py`` on the card: sliced-W2 below half
       the prior's. ``examples/torch_serve_diffusion.py --requests 6
       --bucket-sizes 1,2,4 --nfe 9 --stream``: every request finite, the
       compile-cache misses it adds equal to the buckets it used, the dit-s
       smoke backbone through flash.

    The launch window is the ranks' pipelines and the examples."""
    import contextlib
    import gc
    import io
    import shutil
    import tempfile
    import torch
    from repro_torch.core.samplers import compile_cache_stats
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.empty_cache()
    res: dict = {"phase": "parallel_path"}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        t = time.perf_counter()
        ranks = _run_ranks("--parallel-rank", workdir, PAR_RANKS_DEADLINE_S,
                           "parallel:")
        res["ranks_s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    res["training"] = ranks[0]["training"]
    res["training_rank1_param_err"] = {
        s: ranks[1]["training"][s]["param_err"] for s in PAR_STRATEGIES}
    res["compressed_psum_rank1"] = ranks[1]["training"]["compressed_psum"]
    res["pipeline"] = [{k: v for k, v in r["pipeline"].items()
                        if k != "held"} for r in ranks]
    res["backend"] = ranks[0]["backend"]
    res["peak_gb"] = [r["peak_gb"] for r in ranks]

    # ---- the examples, in this process
    ops.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t = time.perf_counter()
        q = _load_example("torch_quickstart").main(["--device", "cuda"])
        q_s = time.perf_counter() - t
        misses = compile_cache_stats()["misses"]
        t = time.perf_counter()
        sd = _load_example("torch_serve_diffusion").main([
            "--requests", "6", "--bucket-sizes", "1,2,4", "--nfe", "9",
            "--stream", "--device", "cuda"])
        sd_s = time.perf_counter() - t
    examples_launches = ops.launch_counts()
    require(q["finite"] and q["sliced_w2"] < 0.5 * q["prior_sliced_w2"],
            f"parallel: quickstart {q}")
    st = sd["stats"]
    added = st["compile_cache"]["misses"] - misses
    require(len(sd["results"]) == 6 and all(
        bool(torch.isfinite(r.x0).all()) for r in sd["results"]),
        "parallel: serve_diffusion results")
    require(added == len(st["buckets"]),
            f"parallel: serve_diffusion compile misses {added} for buckets "
            f"{list(st['buckets'])}")
    require(examples_launches["flash_attention"] > 0,
            f"parallel: serve_diffusion launched {examples_launches}")
    res["examples"] = {
        "quickstart": dict(q, seconds=q_s),
        "serve_diffusion": {
            "requests": st["requests"], "microbatches": st["microbatches"],
            "padded_slots": st["padded_slots"], "misses_added": added,
            "buckets": list(st["buckets"]), "seconds": sd_s,
            "launches": examples_launches},
        "printed": buf.getvalue().splitlines()[-4:]}
    launches = dict(examples_launches)
    for r in ranks:
        for k, v in r["pipeline"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    state["launches"]["parallel"] = launches
    state["held"]["parallel"] = _merge_held(*(r["pipeline"]["held"]
                                              for r in ranks))
    res["launches"] = launches
    res["held"] = state["held"]["parallel"]
    emit(res)
    return res


def phase_sample_defaults(state: dict) -> dict:
    """The port's sampling entry point, ``launch.sample.main``, with no kernel
    flag on the card: DiT-XL/2 (full config) and the RWKV6 smoke config,
    tame weights, SA NFE 20, two solves each. Each run is its own window
    (main sets the launch counts to 0 before its solves); it must launch
    the arch's kernel on every backbone evaluation and no other arch's."""
    import io
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch import sample as launch_sample
    runs = {}
    for path, arch, smoke, kernel, other in (
            ("sample_dit", "dit-xl-2", False, "flash_attention", "rwkv6_wkv"),
            ("sample_rwkv6", "rwkv6-3b", True, "rwkv6_wkv",
             "flash_attention")):
        cfg = get_smoke(arch) if smoke else get_config(arch)
        per_eval = cfg.n_layers * (2 if kernel == "rwkv6_wkv" else 1)
        argv = ["--arch", arch, "--nfe", str(NFE), "--weights", "tame",
                "--combine", "fused"] + (["--smoke"] if smoke else [])
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            launch_sample.main(argv)
        secs = time.perf_counter() - t
        launches = ops.launch_counts()
        state["launches"][path] = launches
        want = per_eval * NFE * 2  # two solves
        runs[path] = {"argv": argv, "seconds": secs, "launches": launches,
                      "expected": {kernel: want, other: 0},
                      "printed": out.getvalue().strip().splitlines(),
                      "ok": launches[kernel] == want and launches[other] == 0
                      and "finite=True" in out.getvalue()}
    res = {"phase": "sample_defaults", "ok": all(r["ok"] for r in runs.values()),
           "runs": runs}
    emit(res)
    require(res["ok"], f"sampling runs did not route through the kernels: "
            f"{runs}")
    return res


def phase_gmm() -> dict:
    import torch
    from repro_torch.core import GMM, get_schedule, make_sampler
    from repro_torch.core.samplers import get_family
    from repro_torch.core.metrics import sliced_w2
    from repro_torch.kernels import ops
    schedule = get_schedule("vp_linear")
    gmm = GMM.default_2d()
    s = make_sampler("sa", nfe=NFE, tau=1.0, combine="fused",
                     schedule=schedule)
    n = 65536
    g_cpu = torch.Generator().manual_seed(5)
    xT = s.init_noise(g_cpu, (n, 2))
    xis = [torch.randn((n, 2), generator=g_cpu)
           for _ in range(s.spec.n_steps)]
    xis_dev = [x.cuda() for x in xis]
    model = gmm.model_fn(schedule)
    before = ops.launch_counts()
    out = s.sample(model, xT.cuda(), noise=lambda i: xis_dev[i])
    launches = ops.launch_counts()["sa_fused"] - before["sa_fused"]
    out_cpu = s.sample(model, xT, noise=lambda i: xis[i])
    target = gmm.sample(torch.Generator("cuda").manual_seed(6), n)
    sw2 = sliced_w2(out, target, torch.Generator("cuda").manual_seed(7))
    sw2_xT = sliced_w2(xT.cuda(), target, torch.Generator("cuda").manual_seed(7))
    gap = float((out.cpu() - out_cpu).abs().max())
    families = {}
    for name, gated in GMM_FAMILIES.items():
        fs = make_sampler(name, nfe=NFE, tau=1.0, predictor_order=3,
                          corrector_order=0, combine="fused",
                          schedule=schedule)
        conv = get_family(name).model_convention(fs.spec)
        before = ops.launch_counts()
        f_out = fs.sample(gmm.model_fn(schedule, conv), xT.cuda(),
                          noise=lambda i: xis_dev[i])
        after = ops.launch_counts()
        f_sw2 = sliced_w2(f_out, target,
                          torch.Generator("cuda").manual_seed(7))
        families[name] = {
            "sampler": f"{name} nfe=20 tau=1.0 P3C0 fused",
            "convention": conv, "steps": fs.spec.n_steps,
            "launches": {k: after[k] - before[k] for k in after},
            "finite": bool(torch.isfinite(f_out).all()),
            "sliced_w2_x0": f_sw2, "gated": gated,
            "ok": bool(torch.isfinite(f_out).all()) and (
                f_sw2 <= SW2_LIMIT or not gated)}
    baselines = {}
    for name in BASELINES:
        bs = make_sampler(name, nfe=GMM_BASELINE_NFE, tau=1.0,
                          schedule=schedule)
        before = ops.launch_counts()
        b_out = bs.sample(model, xT.cuda(),
                          torch.Generator("cuda").manual_seed(8))
        after = ops.launch_counts()
        b_sw2 = sliced_w2(b_out, target,
                          torch.Generator("cuda").manual_seed(7))
        finite = bool(torch.isfinite(b_out).all())
        baselines[name] = {
            "sampler": f"{name} nfe={GMM_BASELINE_NFE} tau=1.0",
            "steps": bs.spec.n_steps, "nfe": bs.nfe,
            "launches": {k: after[k] - before[k] for k in after},
            "finite": finite, "sliced_w2_x0": b_sw2,
            "limit": 0.5 * sw2_xT, "ok": finite and b_sw2 < 0.5 * sw2_xT}
    res = {"phase": "gmm", "points": n,
           "sampler": "sa nfe=20 tau=1.0 P3C3 PEC fused",
           "sa_fused_launches": launches, "sliced_w2_x0": sw2,
           "sliced_w2_xT": sw2_xT, "sliced_w2_limit": SW2_LIMIT,
           "max_abs_gap_to_cpu_solve": gap, "families": families,
           "baselines": baselines,
           "ok": sw2 <= SW2_LIMIT and all(f["ok"] for f in families.values())
           and all(b["ok"] for b in baselines.values())}
    emit(res)
    require(launches == s.spec.n_steps, f"gmm: sa_fused launched {launches}x")
    require(sw2 <= SW2_LIMIT, f"gmm sliced-W2 {sw2} above {SW2_LIMIT}")
    for name, f in families.items():
        want = dict.fromkeys(f["launches"], 0) | {"sa_update": f["steps"]}
        require(f["launches"] == want,
                f"gmm: {name} launches {f['launches']}, expected {want}")
        require(f["ok"], f"gmm: {name}: {f}")
    for name, b in baselines.items():
        require(b["ok"], f"gmm: {name}: sliced-W2 {b['sliced_w2_x0']} not "
                f"below half the prior's ({b['limit']}), or not finite")
    return res


def phase_rwkv6_path(state: dict) -> dict:
    """SA-Solver over the full-width RWKV6-3B denoiser with the WKV kernel.

    The weights are the contractive (tame) construction, drawn on the card
    from a seed; their Jacobian gain is checked on the float32 stream. The
    published bfloat16 residual stream is the main path (cold and steady
    solve, and one solve with every WKV call held against its plain
    version); the whole-solve comparisons hold the kernel solve against the
    plain-WKV solve at float32 (beside an x_T-nudged yardstick, both under
    GAP_LIMIT) and at bfloat16 (under GAP_LIMIT_BF16)."""
    import torch
    from repro_torch.core import Denoiser, get_schedule, make_sampler
    from repro_torch.core.samplers import eager
    from repro_torch.kernels import ops
    from repro_torch.models import RWKV6
    from repro_torch.models.tame import (ensure_contractive, tame_networks,
                                         tame_rwkv6)
    dev = torch.device("cuda")
    schedule = get_schedule("vp_linear")
    t0 = time.perf_counter()
    model, params, mu = tame_rwkv6("rwkv6-3b", smoke=False, seed=0,
                                   use_kernel=True, latent=SHAPE[2],
                                   device=dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    cfg = model.cfg
    models = {(dt, kernel): RWKV6(dataclasses.replace(
        cfg, dtype=getattr(torch, dt), use_kernel=kernel))
        for dt in ("float32", "bfloat16") for kernel in (True, False)}
    s = make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                     corrector_order=3, mode="PEC", combine="fused",
                     precision="f32", schedule=schedule, prediction="x0")
    g = torch.Generator(dev).manual_seed(21)
    xT = s.init_noise(g, SHAPE)
    contract = ensure_contractive(models["float32", True], params, mu, xT, g)
    xis = [torch.randn(SHAPE, generator=g, device=dev)
           for _ in range(s.spec.n_steps)]

    # one Denoiser per backbone variant, so that each is one compile-cache
    # entry whose graph later solves replay
    dens = {key: Denoiser(tame_networks(m, params, mu)[0], schedule,
                          prediction="x0") for key, m in models.items()}

    def solve(key, x=xT):
        den = dens[key]
        before = ops.launch_counts()
        t = time.perf_counter()
        out = s.sample(den, x, noise=lambda i: xis[i])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = ops.launch_counts()
        return out, secs, {k: after[k] - before[k] for k in after}

    want = {"sa_update": 0, "sa_fused": s.spec.n_steps, "flash_attention": 0,
            "rwkv6_wkv": 2 * cfg.n_layers * s.nfe}
    ops.reset_launch_counts()  # the RWKV6 main-path window starts here
    torch.cuda.reset_peak_memory_stats()
    out_bf, cold, l_cold = solve(("bfloat16", True))
    out_bf2, steady, l_steady = solve(("bfloat16", True))
    require(l_cold == want and l_steady == want,
            f"rwkv6: launches {l_cold} / {l_steady}, expected {want}")
    require(bool(torch.isfinite(out_bf).all()) and
            tuple(out_bf.shape) == SHAPE, "rwkv6: bad output")
    held: dict = {}
    with held_against_plain(held):
        solve(("bfloat16", True))
    state["launches"]["rwkv6"] = ops.launch_counts()  # window ends
    state["held"]["rwkv6"] = held
    peak = torch.cuda.max_memory_allocated()

    # first call of its entry: an eager solve, then the capture; the
    # plain-WKV references run eager only (their graphs would serve no
    # later call)
    out_k32, first_f32, _ = solve(("float32", True))
    with eager():
        out_p32, plain_f32_s, l_plain = solve(("float32", False))
    require(l_plain["rwkv6_wkv"] == 0, "plain-WKV solve launched the kernel")
    v = torch.randn(SHAPE, generator=g, device=dev)
    x_pert = xT + 1e-7 * xT.norm() / v.norm() * v
    out_n32, _, _ = solve(("float32", True), x=x_pert)
    with eager():
        out_pbf, _, _ = solve(("bfloat16", False))
    gaps = {"kernel_vs_plain_wkv_f32": rel_gap(out_k32, out_p32),
            "perturbation_yardstick_f32": rel_gap(out_n32, out_k32),
            "kernel_vs_plain_wkv_bf16": rel_gap(out_bf, out_pbf)}
    info = {"bf16_vs_f32_stream": rel_gap(out_bf, out_k32),
            "x0_minus_anchor_std": float((out_k32 - mu(SHAPE[1])).std())}
    state["rwkv6"] = (dens["bfloat16", True], schedule, xT)
    result = {"phase": "rwkv6_path", "arch": cfg.name,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "heads": cfg.n_heads, "head_dim": cfg.head_dim,
              "d_ff": cfg.d_ff, "chunk": cfg.chunk_size,
              "params": sum(t.numel() for t in _leaves(params)),
              "latent": list(SHAPE), "weights": "tame", "weights_s": weights_s,
              "contractive": contract,
              "sampler": {"name": "sa", "nfe": s.nfe, "tau": 1.0,
                          "predictor_order": 3, "corrector_order": 3,
                          "mode": "PEC", "combine": "fused"},
              "stream": "bfloat16 (published)", "cold_s": cold,
              "steady_s": steady, "first_call_f32_stream_s": first_f32,
              "plain_wkv_f32_stream_eager_s": plain_f32_s,
              "graph_pool_bytes": graph_pool_bytes(),
              "repeat_bitwise": bool(torch.equal(out_bf, out_bf2)),
              "launches_per_solve": l_steady,
              "max_memory_allocated": peak,
              "rel_gap_final": gaps, "gap_limit_f32": GAP_LIMIT,
              "gap_limit_bf16": GAP_LIMIT_BF16, "information": info,
              "held_against_plain": held}
    bad = {k: g_ for k, g_ in gaps.items()
           if not g_ <= (GAP_LIMIT_BF16 if k.endswith("bf16") else GAP_LIMIT)}
    held_bad = {k: r for k, r in held.items() if not r["ok"]}
    result["ok"] = not bad and not held_bad
    emit(result)
    require(not bad, f"rwkv6 whole-solve gaps above their limits: {bad}")
    require(not held_bad, f"kernel calls out of tolerance: {held_bad}")
    require(held.get("rwkv6_wkv", {}).get("calls") == want["rwkv6_wkv"],
            f"rwkv6: held WKV calls {held}")
    return result


def phase_rwkv6_profile(state: dict) -> dict:
    """Where one steady RWKV6-3B solve (bf16 stream, WKV kernel, fused
    combine: a replay of the graph ``rwkv6_path`` captured) spends device
    time; plus one backbone evaluation timed with CUDA events."""
    import torch
    from repro_torch.core import make_sampler
    dev = torch.device("cuda")
    den, schedule, xT = state.pop("rwkv6")
    s = make_sampler("sa", nfe=NFE, tau=1.0, combine="fused",
                     schedule=schedule, prediction="x0")
    g = torch.Generator(dev).manual_seed(1)
    split = _profile_solve(lambda: s.sample(den, xT, g))
    tt = torch.tensor(0.5, device=dev)
    eval_ms = time_ms(lambda: den.network(xT, tt, None), inner=1, samples=5)
    return {"phase": "rwkv6_profile", "ok": True,
            "solve": "fused f32 solver, bf16 stream, steady (a CUDA graph "
                     "replay)", **split,
            "backbone_eval_ms": eval_ms}


#: train_path: DiT-XL/2 full width, batch of latents, steps timed
TRAIN_BATCH = 32
TRAIN_STEPS = 8
#: the reference example's CPU figures (examples/train_denoiser.py
#: --steps 300: loss 1.1763 -> 0.5963), sliced-W2 per (tau, NFE) and of
#: the prior noise; recorded beside the port's, not gated
REF_EXAMPLE_W2 = {"tau=0.0,nfe=10": 0.0887, "tau=0.4,nfe=10": 0.0834,
                  "tau=0.0,nfe=30": 0.0851, "tau=1.0,nfe=30": 0.0901,
                  "prior": 0.0797}


def _load_example(name: str = "torch_train_denoiser"):
    """``examples/<name>.py`` as a module (it is loaded by path:
    ``examples/`` is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_equal(a, b) -> list:
    """Keys of the leaves of two trees that differ in a bit."""
    import torch
    from repro_torch.tree import paths_and_leaves
    bb = dict(paths_and_leaves(b))
    return [k for k, x in paths_and_leaves(a) if not torch.equal(x, bb[k])]


def _rel_per_leaf(got, ref) -> dict:
    """max |got - ref| / max |ref| per leaf key (got moved to ref's
    device)."""
    from repro_torch.tree import paths_and_leaves
    g = dict(paths_and_leaves(got))
    out = {}
    for k, r in paths_and_leaves(ref):
        scale = float(r.abs().max())
        err = float((g[k].to(r.device) - r).abs().max())
        out[k] = err / scale if scale else (0.0 if err == 0 else math.inf)
    return out


def _scale_qk(params: dict, factor: float) -> dict:
    """Scale a transformer's query and key projections in place, in every
    stack: GQA's ``wq``/``wk``, MLA's ``wq_b``/``wk_b`` (logits of a
    smaller scale), and Zamba2's shared block's; a tree without attention
    (RWKV6) is left alone."""
    from repro_torch.models.common import block_stacks
    for blocks in block_stacks(params) + [params.get("shared", {})]:
        a = blocks.get("attn", {})
        for k in ("wq", "wk", "wq_b", "wk_b"):
            if k in a:
                a[k] *= factor
    return params


def _tempered_params(model, seed: int, device):
    """Float32 weights with every leaf off zero (the adaLN-zero init
    leaves the blocks without a gradient) and ``wq``/``wk`` scaled by 0.3
    (attention logits of unit scale; the init's std ~30 saturates the
    softmax, whose float32 gradient is ill-conditioned), drawn on the CPU
    from ``seed``."""
    import torch
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map
    g = torch.Generator().manual_seed(seed)
    p = init_params(g, model.param_defs(), torch.float32)
    p = tree_map(lambda t: t + 0.02 * torch.randn(t.shape, generator=g), p)
    _scale_qk(p, 0.3)
    return tree_map(lambda t: t.to(device), p)


class _StepTimes:
    """A straggler monitor that also keeps every step's seconds."""

    def __init__(self):
        from repro_torch.runtime import StragglerMonitor
        self.monitor = StragglerMonitor()
        self.dts: list = []

    def observe(self, step: int, dt: float) -> bool:
        self.dts.append(dt)
        return self.monitor.observe(step, dt)


def phase_train_path(state: dict) -> dict:
    """Training the DiT denoiser, then sampling it through the kernels.

    (1) ``TRAIN_STEPS`` steps of the checkpointed ``TrainLoop`` at
    DiT-XL/2 full width (28 x 1152, 16 heads of 72, d_ff 4608; the
    config's bfloat16 stream and ``remat="full"``, float32 parameters and
    AdamW state; a batch of ``TRAIN_BATCH`` latents [256, 16]), the plain
    attention (the kernels have no backward) and no kernel launched; the
    async save of the last step timed, restored bitwise, and removed; one
    more step under torch.profiler. (2)
    The same model at 4 layers on a float32 stream: remat "none" against
    "full" bitwise; at DiT smoke width the card's gradients against the
    port's CPU gradients (1e-5 relative per leaf); a run killed at step 3
    of 6 (``save_every=2``) and resumed, bitwise the uninterrupted run.
    (3) The trained full-width parameters, detached, sampled with ``sa``
    at NFE 20 through flash and sa_fused (cold, steady and one held
    solve). (4) ``examples/torch_train_denoiser.py --steps 300`` on the
    card: its loss must fall (the mean of the last 50 below 0.85 x the
    mean of the first 5); its sliced-W2 is recorded beside the
    reference's CPU figures, not gated."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.core import Denoiser, get_schedule, make_sampler
    from repro_torch.data import ShardedBatchIterator, latent_batch
    from repro_torch.kernels import ops
    from repro_torch.models import TransformerLM
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw, chain, clip_by_global_norm
    from repro_torch.runtime import InjectedFailure, TrainLoop
    from repro_torch.tree import paths_and_leaves, tree_leaves, tree_map
    dev = torch.device("cuda")
    ex = _load_example()
    schedule = get_schedule("vp_linear")
    gc.collect()
    torch.cuda.empty_cache()
    result: dict = {"phase": "train_path"}

    # ---- (1) full width -------------------------------------------------
    cfg = dataclasses.replace(get_config("dit-xl-2"), use_flash=False)
    model = TransformerLM(cfg)
    dz, S = cfg.denoiser_latent, REQ_SHAPE[0]
    opt = chain(clip_by_global_norm(1.0), adamw(1e-4, weight_decay=0.0))

    def init_state():
        p = init_params(torch.Generator(dev).manual_seed(0),
                        model.param_defs(), torch.float32)
        return {"params": p, "opt": opt.init(p),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def batches(model_, batch):
        d = model_.cfg.denoiser_latent
        return ShardedBatchIterator(
            lambda rows, step, host: latent_batch(d, S, rows, step, host),
            batch, device=dev)

    tmp = tempfile.mkdtemp(prefix="train_path_")
    free_gb = shutil.disk_usage(tmp).free / 1e9
    times = _StepTimes()
    train_step = ex.make_train_step(model, opt, schedule, ex.seeded_draw)
    loop = TrainLoop(train_step, init_state, os.path.join(tmp, "full"),
                     save_every=TRAIN_STEPS, monitor=times)
    saver, saved = loop.saver, {}
    real_save, real_wait = saver.save, saver.wait

    def timed_save(step, tree):
        t = time.perf_counter()
        real_save(step, tree)
        saved["host_copy_s"] = time.perf_counter() - t

    def timed_wait():
        t = time.perf_counter()
        real_wait()
        saved["drain_s"] = time.perf_counter() - t

    saver.save, saver.wait = timed_save, timed_wait
    ops.reset_launch_counts()  # the train_path window starts here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trained, hist = loop.run(batches(model, TRAIN_BATCH), TRAIN_STEPS,
                             log_every=1, log=lambda m: print(m, flush=True))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    saver.close()
    train_launches = ops.launch_counts()
    losses = [h["loss"] for h in hist]
    step_dir = os.path.join(tmp, "full", f"step_{TRAIN_STEPS:08d}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
    t = time.perf_counter()
    restored, rstep = ckpt.restore(os.path.join(tmp, "full"), trained)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    restore_diff = _tree_equal(restored, trained)
    del restored
    shutil.rmtree(tmp, ignore_errors=True)
    # one more step under torch.profiler: device time by kernel category
    profile_step = _profile_solve(lambda: train_step(
        trained, next(batches(model, TRAIN_BATCH))))
    steady = statistics.median(times.dts[1:])
    n_params = sum(t.numel() for t in tree_leaves(trained["params"]))
    result["full_width"] = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "head_dim": cfg.hd, "d_ff": cfg.d_ff,
        "stream": str(cfg.dtype).removeprefix("torch."), "remat": cfg.remat,
        "params": n_params, "batch": [TRAIN_BATCH, S, dz],
        "optimizer": "clip 1.0 -> adamw(1e-4, wd 0), f32 state",
        "steps": len(losses), "losses": losses,
        "step_s": times.dts, "steady_step_s": steady,
        "tokens_per_s": TRAIN_BATCH * S / steady, "run_s": run_s,
        "max_memory_allocated": peak, "profile_one_step": profile_step,
        "launches_while_training": train_launches,
        "checkpoint": {"bytes": ckpt_bytes, "leaves": len(
            paths_and_leaves(trained)), "host_copy_s": saved.get(
            "host_copy_s"), "drain_s": saved.get("drain_s"),
            "restore_s": restore_s, "restored_step": rstep,
            "restore_bitwise": not restore_diff,
            "tmp_free_gb_before": free_gb}}
    emit(result)
    require(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
            f"train_path: losses {losses}")
    require(not any(train_launches.values()),
            f"train_path: training launched kernels {train_launches}")
    require(rstep == TRAIN_STEPS and not restore_diff,
            f"train_path: restore differs at {restore_diff}")

    # ---- (3) sample the trained full-width parameters --------------------
    params = tree_map(torch.Tensor.detach, trained["params"])
    del trained, loop, saver
    sampler_model = TransformerLM(dataclasses.replace(cfg, use_flash=None))
    den = Denoiser(lambda x, t_, c: sampler_model.denoise(params, x, t_),
                   schedule, prediction="x0")
    s = make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                     corrector_order=3, mode="PEC", combine="fused",
                     schedule=schedule, prediction="x0")
    g = torch.Generator(dev).manual_seed(31)
    xT = s.init_noise(g, SHAPE)
    want = dict.fromkeys(ops.launch_counts(), 0) | {
        "flash_attention": cfg.n_layers * s.nfe, "sa_fused": s.spec.n_steps}
    solves = []
    for _ in range(2):  # the entry's first call, then a replay
        before = ops.launch_counts()
        t = time.perf_counter()
        out = s.sample(den, xT, torch.Generator(dev).manual_seed(32))
        torch.cuda.synchronize()
        after = ops.launch_counts()
        solves.append((out, time.perf_counter() - t,
                       {k: after[k] - before[k] for k in after}))
    held: dict = {}
    with held_against_plain(held):
        s.sample(den, xT, torch.Generator(dev).manual_seed(32))
    out = solves[1][0]
    result["sampled"] = {
        "sampler": {"name": "sa", "nfe": s.nfe, "tau": 1.0,
                    "predictor_order": 3, "corrector_order": 3,
                    "mode": "PEC", "combine": "fused"},
        "latent": list(SHAPE), "cold_s": solves[0][1],
        "steady_s": solves[1][1],
        "launches_per_solve": [l for _, _, l in solves],
        "finite": bool(torch.isfinite(out).all()),
        "repeat_bitwise": bool(torch.equal(solves[0][0], out)),
        "x0_std": float(out.std()), "held_against_plain": held}
    del params, den, sampler_model, solves, out
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (2) 4 layers at full width, float32 stream ----------------------
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype=torch.float32,
                               remat="none")
    m_none, m_full = TransformerLM(cfg4), TransformerLM(
        dataclasses.replace(cfg4, remat="full"))
    p4 = _tempered_params(m_none, 4, dev)
    x0 = torch.from_numpy(latent_batch(dz, S, 8, 0)["x0"]).to(dev)
    tt, eps = ex.seeded_draw(0, x0)
    l_none, g_none = ex.loss_and_grads(m_none, p4, x0, tt, eps, schedule)
    l_full, g_full = ex.loss_and_grads(m_full, p4, x0, tt, eps, schedule)
    remat_diff = _tree_equal(g_none, g_full)
    remat_diff += [] if torch.equal(l_none, l_full) else ["loss"]
    del p4, g_none, g_full

    sm = TransformerLM(dataclasses.replace(
        get_smoke("dit-xl-2"), n_layers=4, dtype=torch.float32,
        use_flash=False))
    p_cpu = _tempered_params(sm, 6, "cpu")
    xs = torch.from_numpy(latent_batch(sm.cfg.denoiser_latent, 16, 4,
                                       0)["x0"])
    ts, es = ex.seeded_draw(0, xs)
    _, g_cpu = ex.loss_and_grads(sm, p_cpu, xs, ts, es, schedule)
    _, g_dev = ex.loss_and_grads(
        sm, tree_map(lambda t: t.to(dev), p_cpu), xs.to(dev), ts.to(dev),
        es.to(dev), schedule)
    cpu_rel = _rel_per_leaf(g_dev, g_cpu)

    opt4 = chain(clip_by_global_norm(1.0), adamw(1e-4, weight_decay=0.0))
    m_train = TransformerLM(dataclasses.replace(cfg4, remat="full"))

    def init4():
        p = _tempered_params(m_train, 7, dev)
        return {"params": p, "opt": opt4.init(p),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    step4 = ex.make_train_step(m_train, opt4, schedule, ex.seeded_draw)
    tmp = tempfile.mkdtemp(prefix="train_path_resume_")
    try:
        ref_state, ref_hist = TrainLoop(
            step4, init4, os.path.join(tmp, "a"), save_every=2).run(
            batches(m_train, 8), 6, log=None)
        killed = False
        try:
            TrainLoop(step4, init4, os.path.join(tmp, "b"),
                      save_every=2).run(batches(m_train, 8), 6, fail_at=3,
                                        log=None)
        except InjectedFailure:
            killed = True
        res_state, res_hist = TrainLoop(
            step4, init4, os.path.join(tmp, "b"), save_every=2).run(
            batches(m_train, 8), 6, log=None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resume_diff = _tree_equal(res_state, ref_state)
    result["four_layers"] = {
        "remat_none_vs_full_bitwise": not remat_diff,
        "card_vs_cpu_grad_rel": max(cpu_rel.values()),
        "card_vs_cpu_grad_rel_per_leaf": cpu_rel,
        "resume": {"killed_at": 3, "of": 6, "save_every": 2,
                   "killed": killed, "resumed_steps": len(res_hist),
                   "metric_stream_bitwise": res_hist == ref_hist[2:],
                   "final_state_bitwise": not resume_diff}}
    del ref_state, res_state
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (4) the example, 300 steps on the card --------------------------
    tmp = tempfile.mkdtemp(prefix="train_path_example_")
    try:
        t = time.perf_counter()
        exo = ex.main(["--steps", "300", "--ckpt", os.path.join(tmp, "c"),
                       "--fresh"])
        example_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    el = exo["losses"]
    first5, last50 = statistics.mean(el[:5]), statistics.mean(el[-50:])
    result["example"] = {
        "steps": len(el), "seconds": example_s, "loss_first": el[0],
        "loss_last": el[-1], "mean_first5": first5, "mean_last50": last50,
        "falls": last50 < 0.85 * first5, "sliced_w2": exo["sliced_w2"],
        "prior_sliced_w2": exo["prior_sliced_w2"],
        "reference_cpu_sliced_w2": REF_EXAMPLE_W2}
    state["launches"]["train"] = ops.launch_counts()  # window ends
    state["held"]["train"] = held
    gc.collect()
    torch.cuda.empty_cache()

    smp, four = result["sampled"], result["four_layers"]
    checks = {
        "sample_launches": all(l == want for l in smp["launches_per_solve"]),
        "sample_finite": smp["finite"],
        "held": all(r["ok"] for r in held.values()) and held.get(
            "flash_attention", {}).get("calls") == want["flash_attention"],
        "remat_bitwise": four["remat_none_vs_full_bitwise"],
        "card_vs_cpu": four["card_vs_cpu_grad_rel"] <= 1e-5,
        "resume": killed and four["resume"]["metric_stream_bitwise"]
        and four["resume"]["final_state_bitwise"],
        "example_loss_falls": result["example"]["falls"]}
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit({k: v for k, v in result.items() if k != "full_width"})
    require(result["ok"], f"train_path: failed checks "
            f"{[k for k, v in checks.items() if not v]} (want {want}; "
            f"resume diff {resume_diff}; remat diff {remat_diff})")
    return result


#: lm_path: the LM served at full width (prompt, decode steps, batch) and
#: its consistency checks (layers, prompt before decoding, batch)
LM_BATCH = 8
LM_PROMPT = 512
LM_DECODE = 16
LM_RAGGED = 200   # three WKV chunks of 64 and 8 tokens sequential
LM_SHORT = 32     # launch.serve's default prompt: under one chunk
LM_CHECK_LAYERS = 4
LM_CHECK_PREFILL = 448
LM_CHECK_CPU_SEQ = 128
LM_CHECK_LIMIT = 1e-4
#: the consistency checks' factor on starcoder2-3b's wq/wk: at the init's
#: scale its attention logits have std ~100 (d_model 3072 over 24 heads),
#: a softmax sharp enough to amplify float32 rounding past the gate (the
#: check reports a 1e-7 weight nudge's effect beside its gaps); at 0.1
#: the logits have std ~1
LM_QK_SCALE = 0.1
#: the LM's kernel calls: flash (B, H, K, S, T, hd, causal) on
#: starcoder2-3b's and gemma-7b's forwards, WKV (B, T, H, hd) with a
#: carried state
LM_FLASH_SHAPE = (8, 24, 2, 512, 512, 128, True)
LM_FLASH_SHAPE_HD256 = (8, 16, 16, 512, 512, 256, True)
LM_WKV_SHAPE = (8, 512, 40, 64)


def _lm_params(model, device, seed: int = 0, cpu_draw: bool = False):
    """Float32 weights from ``seed`` (drawn on the card, or on the CPU and
    moved when ``cpu_draw``: the same weights for a card-vs-CPU check);
    a transformer's ``wq``/``wk`` scaled by ``LM_QK_SCALE`` when drawn on
    the CPU (attention logits of unit scale)."""
    import torch
    from repro_torch.models.common import init_params
    from repro_torch.tree import tree_map
    if not cpu_draw:
        return init_params(torch.Generator(device).manual_seed(seed),
                           model.param_defs(), torch.float32, device)
    p = init_params(torch.Generator().manual_seed(seed), model.param_defs(),
                    torch.float32)
    _scale_qk(p, LM_QK_SCALE)
    return tree_map(lambda t: t.to(device), p)


def _seeded_params(model, dev, dtype, seed: int) -> dict:
    """Weights of ``model`` from ``seed`` on the card, query and key
    projections scaled by ``LM_QK_SCALE``. float32 through
    ``init_params`` (drawn in place); a narrower dtype a block of a leaf's
    leading axis at a time (at most 2**28 values), drawn in float32 and
    rounded: a float32 leaf of deepseek-v3's MoE stack beside its
    bfloat16 copy would not fit."""
    import torch
    from repro_torch.models.common import init_params, tree_defs_map
    g = torch.Generator(dev).manual_seed(seed)
    if dtype == torch.float32:
        return _scale_qk(init_params(g, model.param_defs(), dtype, dev),
                         LM_QK_SCALE)

    def draw(d):
        if d.init in ("zeros", "ones"):
            return d.materialize(g, dtype, dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.init == "normal" else d.scale / math.sqrt(fan_in)
        out = torch.empty(d.shape, dtype=dtype, device=dev)
        rows = max(1, 2**28 // max(1, math.prod(d.shape[1:])))
        for i in range(0, d.shape[0], rows):
            blk = out[i:i + rows]
            blk.copy_(torch.empty(blk.shape, device=dev).normal_(
                generator=g).mul_(std))
        return out

    return _scale_qk(tree_defs_map(draw, model.param_defs()), LM_QK_SCALE)


def _lm_served(model, params, prompt, n_decode: int) -> dict:
    """Prefill ``prompt`` (tokens [B, S], or ``{"embeds": [B, S, d]}`` for
    an embeddings-input model, whose decode steps take the embedding of
    the token chosen) into a fresh cache, then ``n_decode`` greedy decode
    steps, each synchronized and timed; launches of each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    embeds = "embeds" in batch
    B, S = next(iter(batch.values())).shape[:2]
    dev = next(iter(batch.values())).device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(B, S + n_decode, device=dev)
    before = ops.launch_counts()
    t = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    mid = ops.launch_counts()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    steps, toks = [], [tok]
    for i in range(n_decode):
        t = time.perf_counter()
        step_in = F.embedding(tok, params["embed"]) if embeds else tok
        logits, cache = model.decode_step(params, step_in, cache, S + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        toks.append(tok)
    after = ops.launch_counts()
    ms = sorted(1e3 * x for x in steps)
    toks = torch.cat(toks, dim=1)
    return {"batch": B, "prompt": S, "decode_steps": n_decode,
            "prefill_s": prefill_s, "prefill_tokens_per_s": B * S / prefill_s,
            "decode_ms_per_token_p50": ms[len(ms) // 2],
            "decode_ms_per_token_p90": ms[int(0.9 * (len(ms) - 1))],
            "decode_tokens_per_s": B * n_decode / sum(steps),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "prefill_launches": {k: mid[k] - before[k] for k in mid},
            "decode_launches": {k: after[k] - mid[k] for k in after},
            "finite": bool(torch.isfinite(logits).all()),
            "sample_ids": toks[0, :12].tolist()}


def _lm_consistency(arch: str, layers: int = LM_CHECK_LAYERS) -> dict:
    """``layers`` layers of ``arch`` at full width, float32 stream
    and cache, on the card: forward's last logits against prefill's;
    prefill(``LM_CHECK_PREFILL``) + decode steps to ``LM_PROMPT`` against
    forward's logits at each of those positions; the card's forward
    against the port's on the CPU over ``LM_CHECK_CPU_SEQ`` tokens, on the
    same weights. Each as max |diff| over the reference logits' peak;
    beside them, the card's forward with every weight nudged by 1e-7
    relative (a yardstick of the network's own conditioning, not gated).
    An embeddings-input arch takes seeded embeddings, each decode step
    the next position's; an M-RoPE arch its text-only positions."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype=torch.float32)
    if hasattr(cfg, "cache_dtype"):
        cfg = dataclasses.replace(cfg, cache_dtype=torch.float32)
    model = build_model(cfg)
    params = _lm_params(model, dev, seed=3, cpu_draw=True)
    g = torch.Generator().manual_seed(5)
    key = getattr(cfg, "input_mode", "tokens")  # "tokens" or "embeds"
    toks = torch.randn((2, LM_PROMPT, cfg.d_model), generator=g) \
        if key == "embeds" else \
        torch.randint(0, cfg.vocab_size, (2, LM_PROMPT), generator=g)
    tk = toks.to(dev)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    with torch.no_grad():
        fw, _ = model.forward(params, {key: tk})
        lg, _ = model.prefill(params, {key: tk},
                              model.init_cache(2, LM_PROMPT, device=dev))
        last = rel(lg[:, 0], fw[:, -1])
        k = LM_CHECK_PREFILL
        cache = model.init_cache(2, LM_PROMPT, device=dev)
        lg, cache = model.prefill(params, {key: tk[:, :k]}, cache)
        gaps = [rel(lg[:, 0], fw[:, k - 1])]
        for i in range(k, LM_PROMPT - 1):
            lg, cache = model.decode_step(params, tk[:, i:i + 1], cache, i)
            gaps.append(rel(lg[:, 0], fw[:, i]))
        n = LM_CHECK_CPU_SEQ
        card, _ = model.forward(params, {key: tk[:, :n]})
        gn = torch.Generator(dev).manual_seed(9)
        nudge = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
            t.shape, generator=gn, device=dev)), params)
        nudged, _ = model.forward(nudge, {key: tk[:, :n]})
        del nudge
        cpu_params = tree_map(lambda t: t.cpu(), params)
        del params
        cpu, _ = model.forward(cpu_params, {key: toks[:, :n]})
    res = {"layers": layers, "batch": 2, "input": key,
           "forward_vs_prefill_last": last,
           "prefill_then_decode_vs_forward": max(gaps),
           "decode_steps": len(gaps) - 1,
           "card_vs_cpu_forward": rel(card.cpu(), cpu),
           "weights_nudged_1e-7_yardstick": rel(nudged, card),
           "cpu_seq": n, "logits_peak": float(fw.abs().max())}
    res["ok"] = max(last, max(gaps), res["card_vs_cpu_forward"]) \
        <= LM_CHECK_LIMIT
    return res


def _causal_flash_times(shape, seed: int) -> dict:
    """Causal flash at ``shape`` (B, H, K, S, T, hd, causal), f32: kernel,
    plain and SDPA (on K/V repeated to H heads) ms, and the bound."""
    import torch
    from repro_torch.kernels import ops
    B, H, K, S, T, hd, causal = shape
    q, k, v = _attn_inputs(B, H, K, S, T, hd, torch.float32, seed=seed)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kk = k.repeat_interleave(H // K, dim=1)
    vv = v.repeat_interleave(H // K, dim=1)
    # causal: the scores on and below the diagonal, each a q.k and a p.v
    # (kernels/flash_attention.py::cost)
    flash_ops, flash_bytes = flash_cost(B, H, K, S, T, hd, True, 4)
    return {
        "shape": list(shape),
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        "plain_ms": time_ms(lambda: ops.flash_attention(
            q, k, v, causal=True, mode="plain"), inner=5, samples=20),
        "library_ms": time_ms(lambda: sdpa(q, kk, vv, is_causal=True)),
        "library": f"scaled_dot_product_attention on K/V repeated to {H} "
                   "heads" if H != K else "scaled_dot_product_attention",
        "bound": bound(flash_bytes, 3 * flash_ops, PEAK_TF32_FLOP_PER_S)}


def lm_kernel_times() -> dict:
    """Flash and WKV at the LM's shapes (f32), kernel against plain, with
    SDPA beside flash and each one's bound; flash also at gemma-7b's head
    dim 256."""
    import torch
    from repro_torch.kernels import ops
    out = {"flash_attention": _causal_flash_times(LM_FLASH_SHAPE, seed=29),
           "flash_attention_hd256": _causal_flash_times(
               LM_FLASH_SHAPE_HD256, seed=37)}
    Bw, Tw, Hw, hdw = LM_WKV_SHAPE
    args = _wkv_inputs(Bw, Tw, Hw, hdw, torch.float32, torch.float32,
                       seed=31, decay_shift=4.0)
    out["rwkv6_wkv"] = {
        "shape": list(LM_WKV_SHAPE), "chunk": WKV_CHUNK, "S0": "nonzero",
        "ms": time_ms(lambda: ops.wkv(*args, chunk=WKV_CHUNK)),
        "plain_ms": time_ms(lambda: ops.wkv(*args, chunk=WKV_CHUNK,
                                            mode="plain"),
                            inner=3, samples=10),
        "library_ms": None,
        "bound": bound(*wkv_bytes_ops(Bw, Tw, Hw, hdw, WKV_CHUNK))}
    for t in out.values():
        t["bound_ms"], t["bound_by"] = t.pop("bound")
    return out


def phase_lm_path(state: dict) -> dict:
    """The LM path served at full width, then checked at 4 layers.

    starcoder2-3b (30 layers, d_model 3072, 24 query / 2 KV heads of 128,
    d_ff 12,288, vocab 49,152) and RWKV6-3B as an LM (32 layers, d_model
    2560, 40 heads of 64, vocab 65,536), float32 weights from a seed, the
    published bfloat16 stream and cache, batch ``LM_BATCH``:
    starcoder2-3b's cache-free ``forward`` at ``LM_PROMPT`` tokens (flash,
    causal, GQA 12:1, one launch a layer), then ``prefill`` of
    ``LM_PROMPT`` tokens and ``LM_DECODE`` greedy ``decode_step`` s (the
    cached attention is the plain one: no launch); RWKV6's ``prefill`` of
    ``LM_PROMPT`` tokens (one WKV launch a layer), a ragged one of
    ``LM_RAGGED`` (three chunks through the kernel, the tail sequential:
    one launch a layer), one of ``LM_SHORT`` (under one chunk: no
    launch) and ``LM_DECODE`` decode steps (no launch). One more forward
    and two prefills with every kernel call held against its plain
    version. Then the 4-layer consistency checks (``_lm_consistency``),
    ``launch.serve.main`` on the card (``--mode lm`` for both archs at
    full width, ``--mode diffusion --requests 8``), one decode step and one
    prefill of each arch under torch.profiler, and the kernels' times at
    the LM's shapes."""
    import gc
    import io

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    result: dict = {"phase": "lm_path", "stream": "bfloat16 (published)",
                    "cache": "bfloat16 (published)", "weights": "float32"}
    held: dict = {}
    checks: dict = {}
    ops.reset_launch_counts()  # the LM main-path window starts here
    t_phase = time.perf_counter()
    for arch in ("starcoder2-3b", "rwkv6-3b"):
        cfg = get_config(arch)
        model = build_model(cfg)
        t = time.perf_counter()
        params = _lm_params(model, dev)
        torch.cuda.synchronize()
        r: dict = {"layers": cfg.n_layers, "d_model": cfg.d_model,
                   "vocab": cfg.vocab_size, "weights_s":
                   time.perf_counter() - t,
                   "params": sum(t_.numel() for t_ in _leaves(params))}
        g = torch.Generator(dev).manual_seed(7)
        prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                               generator=g, device=dev)
        per_layer = {"flash_attention": 0, "rwkv6_wkv": 0} | (
            {"flash_attention": cfg.n_layers} if arch == "starcoder2-3b"
            else {"rwkv6_wkv": cfg.n_layers})
        with torch.no_grad():
            if arch == "starcoder2-3b":
                fw = {}
                for i in range(2):
                    _, secs, launches, _, _ = launch_window(
                        lambda: model.forward(params, {"tokens": prompt}))
                    fw[f"run{i}"] = {"seconds": secs, "launches": launches}
                r["forward"] = fw
                checks["forward_flash_launches"] = all(
                    f["launches"] == only_launches(flash_attention=30)
                    for f in fw.values())
                with held_against_plain(held):
                    model.forward(params, {"tokens": prompt})
            served = _lm_served(model, params, prompt, LM_DECODE)
            r["served"] = served
            want_prefill = only_launches(
                rwkv6_wkv=per_layer["rwkv6_wkv"])
            checks[f"{arch}_prefill_launches"] = \
                served["prefill_launches"] == want_prefill
            checks[f"{arch}_decode_no_launch"] = \
                served["decode_launches"] == only_launches()
            checks[f"{arch}_finite"] = served["finite"]
            r["profile_decode_step"] = _profile_solve(
                lambda: model.decode_step(
                    params, prompt[:, :1],
                    model.init_cache(LM_BATCH, LM_PROMPT + 1, device=dev),
                    LM_PROMPT))
            if arch == "rwkv6-3b":
                for name, T, launches in (
                        ("ragged", LM_RAGGED, cfg.n_layers),
                        ("short", LM_SHORT, 0)):
                    out, secs, got, _, _ = launch_window(
                        lambda: model.prefill(
                            params, {"tokens": prompt[:, :T]},
                            model.init_cache(LM_BATCH, device=dev)))
                    r[f"prefill_{name}"] = {
                        "tokens": T, "seconds": secs, "launches": got,
                        "finite": bool(torch.isfinite(out[0]).all())}
                    checks[f"rwkv6_{name}_prefill"] = got == only_launches(
                        rwkv6_wkv=launches) and r[f"prefill_{name}"]["finite"]
                with held_against_plain(held):
                    for T in (LM_PROMPT, LM_RAGGED):
                        model.prefill(params, {"tokens": prompt[:, :T]},
                                      model.init_cache(LM_BATCH, device=dev))
            r["profile_prefill"] = _profile_solve(
                lambda: model.prefill(
                    params, {"tokens": prompt},
                    model.init_cache(LM_BATCH, LM_PROMPT, device=dev)))
        result[arch] = r
        del params, model
        gc.collect()
        torch.cuda.empty_cache()

    result["consistency"] = {arch: _lm_consistency(arch)
                             for arch in ("starcoder2-3b", "rwkv6-3b")}
    gc.collect()
    torch.cuda.empty_cache()
    checks["consistency"] = all(c["ok"] for c in
                                result["consistency"].values())

    cli = {}
    for name, argv in (
            ("lm_starcoder2-3b", ["--mode", "lm", "--arch", "starcoder2-3b",
                                  "--batch", "8", "--gen", "8"]),
            ("lm_rwkv6-3b", ["--mode", "lm", "--arch", "rwkv6-3b",
                             "--batch", "8", "--prompt-len", "100",
                             "--gen", "8"]),
            ("diffusion", ["--mode", "diffusion", "--requests", "8"])):
        buf = io.StringIO()
        before = ops.launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        cli[name] = {"argv": argv, "seconds": time.perf_counter() - t,
                         "launches": {k: after[k] - before[k] for k in after},
                         "printed": buf.getvalue().strip().splitlines()}
        gc.collect()
        torch.cuda.empty_cache()
    result["launch_serve"] = cli
    checks["serve_lm_rwkv6_wkv"] = cli["lm_rwkv6-3b"]["launches"] == \
        only_launches(rwkv6_wkv=32)
    checks["serve_lm_printed"] = all(
        any(ln.startswith("sample token ids:") for ln in
            cli[n]["printed"]) for n in ("lm_starcoder2-3b",
                                             "lm_rwkv6-3b"))
    checks["serve_diffusion_printed"] = any(
        ln.startswith("served 8 requests") for ln in
        cli["diffusion"]["printed"])
    state["launches"]["lm"] = ops.launch_counts()  # window ends
    state["held"]["lm"] = held
    result["launches"] = state["launches"]["lm"]
    checks["held"] = all(h["ok"] for h in held.values()) and held.get(
        "flash_attention", {}).get("calls") == 30 and held.get(
        "rwkv6_wkv", {}).get("calls") == 64
    result["held_against_plain"] = held
    result["kernel_times"] = lm_kernel_times()
    result["seconds"] = time.perf_counter() - t_phase
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit(result)
    require(result["ok"], f"lm_path: failed checks "
            f"{[k for k, v in checks.items() if not v]}")
    return result


#: lm_train_path: the LM trained at full width through launch.train's
#: step (steps, batch x tokens, the peak LR, warmed up over 10 steps as
#: the driver warms it; at the driver's default 3e-4 both archs' losses
#: diverge by the third step, where the LR is 6e-5: Adam's first steps
#: move every element by about the LR), and its checks: the card's gradients against the CPU's at
#: ``LM_GRAD_LAYERS`` layers of full width, over a batch of
#: ``LM_GRAD_BATCH`` x ``LM_GRAD_SEQ`` tokens, within ``LM_GRAD_LIMIT`` of
#: each leaf's scale; the driver's CLI killed and resumed at smoke width
LM_TRAIN_ARCHS = ("starcoder2-3b", "rwkv6-3b")
LM_TRAIN_STEPS = 4
LM_TRAIN_BATCH = 8
LM_TRAIN_SEQ = 512
LM_TRAIN_LR = 3e-5
LM_GRAD_LAYERS = 4
LM_GRAD_BATCH = 2
LM_GRAD_SEQ = 128
LM_GRAD_LIMIT = 1e-5
#: the CLI's resume check: --steps, --fail-at, --save-every (smoke width)
LM_RESUME = (12, 7, 5)


def _temper_lm(params: dict) -> dict:
    """Temper LM weights in place, as the CPU tests do: a transformer's
    attention projections rescaled to the usual fan-in (the reference's
    ``scaled`` init divides a [d, H, hd] projection by sqrt(H), not
    sqrt(d): at starcoder2-3b's width q, k and v have std 11-39, each
    layer adds ~190 to the residual stream, and at 30 layers the float32
    gradient norm overflows), so that q, k, v and each layer's output
    have std ~1; RWKV6's ``w0`` lowered by 2 (decays of ~exp(-0.2) a
    token) and ``wr``/``wk`` scaled by 0.1 (receptance-key scores of std
    below 1): at the init the cumulative log-decay of a chunk reaches
    ~-300, and float32 sums taken in other orders move the gradients far
    past the 1e-5 gate. Both stacks of a MoE model (``blocks`` and
    ``moe_blocks``) are tempered; MLA's latent projections ``wq_b``,
    ``wk_b`` and ``wv_b`` ([r, H, k], divided by sqrt(H)) are rescaled to
    the fan-in r, its ``wo`` to H x v."""
    from repro_torch.models.common import block_stacks
    for blocks in block_stacks(params):
        if "tm" in blocks:
            blocks["tm"]["w0"] -= 2.0
            for k in ("wr", "wk"):
                blocks["tm"][k] *= 0.1
            continue
        a = blocks["attn"]
        if "wq_b" in a:
            r, H = a["wk_b"].shape[1], a["wk_b"].shape[2]
            for k in ("wq_b", "wk_b", "wv_b"):
                a[k] *= math.sqrt(H / r)
        else:
            d, H, K = a["wq"].shape[1], a["wq"].shape[2], a["wk"].shape[2]
            a["wq"] *= math.sqrt(H / d)
            a["wk"] *= math.sqrt(K / d)
            a["wv"] *= math.sqrt(K / d)
        a["wo"] *= 1 / math.sqrt(H)
    return params


def phase_lm_train_path(state: dict) -> dict:
    """Training the LM through ``launch.train``, on the card.

    (1) starcoder2-3b (30 layers, d_model 3072, 24 query / 2 KV heads of
    128, vocab 49,152) and RWKV6-3B (32 layers, d_model 2560, vocab
    65,536) at published widths and depths: ``LM_TRAIN_STEPS`` steps of
    the driver's step (float32 weights and AdamW state, every buffer
    donated; the configs' bfloat16 stream and ``remat="full"``; the plain
    attention and WKV paths: no kernel launched) on its
    ``synthetic_lm_batch`` stream of ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ``
    tokens, from the driver's init tempered (``_temper_lm``; the
    gradient norm at the untempered init is recorded): s/step, tokens/s,
    peak memory, the losses (the first batch's must fall: it is
    evaluated again after the steps), and one more step under
    torch.profiler. (2) ``LM_GRAD_LAYERS`` layers
    at full width on a float32 stream: the loss and every gradient leaf
    on the card against the port's on the CPU, on the same tempered
    weights, within ``LM_GRAD_LIMIT`` of each leaf's scale. (3) The
    driver's CLI at smoke width on the card: ``--fail-at`` and then
    ``--resume auto`` give the uninterrupted run's loss stream and state
    bit for bit. (4) ``examples/torch_lm_train_resume.py`` on the card:
    its retrained steps repeat run 1's losses bit for bit."""
    import gc
    import io
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as lt
    from repro_torch.models import build_model, init_params
    from repro_torch.optim import global_norm
    from repro_torch.runtime import InjectedFailure
    from repro_torch.tree import paths_and_leaves, tree_leaves, tree_map
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    result: dict = {"phase": "lm_train_path", "stream": "bfloat16 "
                    "(published)", "weights_and_adamw": "float32",
                    "remat": "full", "lr": LM_TRAIN_LR, "warmup_steps": 10}
    checks: dict = {}
    ops.reset_launch_counts()  # the lm_train window starts here
    t_phase = time.perf_counter()

    # ---- (1) published widths and depths -------------------------------
    for arch in LM_TRAIN_ARCHS:
        cfg = get_config(arch)
        model = build_model(lt.train_config(cfg))
        opt = lt.make_optimizer(LM_TRAIN_LR, LM_TRAIN_STEPS)
        step = lt.make_train_step(model, opt)
        batches = lt.make_batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        st = lt.make_init_state(model, opt, dev)()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        # the driver's own init: the gradient norm on the first batch
        # (recorded; the steps below start from the tempered weights)
        _, g0 = lt.loss_and_grads(model, st["params"], next(batches))
        raw_gnorm = float(global_norm(g0))
        del g0
        torch.cuda.empty_cache()  # its blocks would fragment the steps
        _temper_lm(st["params"])
        batches.step = 0
        losses, gnorms, dts = [], [], []
        for i in range(LM_TRAIN_STEPS):
            b = next(batches)
            first = b if i == 0 else first
            t = time.perf_counter()
            st, m = step(st, b)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
        peak = torch.cuda.max_memory_allocated()
        state.setdefault("peaks", {})[f"lm_train_{arch}"] = {
            "measured_bytes": peak - before,
            "what": f"lm_train_path's {arch} (init, the driver-init gradient "
                    f"and its norm, {LM_TRAIN_STEPS} steps at "
                    f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}): "
                    "max_memory_allocated less the allocation before the "
                    "init"}
        n_params = sum(t_.numel() for t_ in tree_leaves(st["params"]))
        with torch.no_grad():  # the first batch again, after the steps
            first_again = float(model.loss_fn(st["params"], first))
        prof = _profile_solve(lambda: step(st, next(batches)))
        steady = statistics.median(dts[1:])
        result[arch] = {
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "params": n_params,
            "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ], "init_s": init_s,
            "step_s": dts, "steady_step_s": steady,
            "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / steady,
            "losses": losses, "gnorms": gnorms,
            "first_batch_loss_after": first_again,
            "driver_init_gnorm": raw_gnorm,
            "max_memory_allocated_gb": peak / 1e9,
            "profile_one_step": prof}
        checks[f"{arch}_finite"] = all(map(math.isfinite, losses + gnorms))
        checks[f"{arch}_loss_falls"] = first_again < losses[0]
        del st, step, opt, model, batches, first
        gc.collect()
        torch.cuda.empty_cache()
        emit({"progress": "lm_train_path", "arch": arch,
              "steady_step_s": steady, "losses": losses,
              "max_memory_allocated_gb": peak / 1e9})

    sections = {"full_width": time.perf_counter() - t_phase}

    # ---- (2) gradients at 4 layers: the card against the CPU -----------
    t_sec = time.perf_counter()
    grads = {}
    for arch in LM_TRAIN_ARCHS:
        cfg = dataclasses.replace(
            lt.train_config(get_config(arch)), n_layers=LM_GRAD_LAYERS,
            dtype=torch.float32)
        model = build_model(cfg)
        # drawn on the card (a CPU draw of ~680 M values takes seconds),
        # tempered, and copied to the CPU: the same weights on both sides
        p_cpu = tree_map(lambda x: x.cpu(), _temper_lm(init_params(
            torch.Generator(dev).manual_seed(11), model.param_defs(),
            torch.float32)))
        b = synthetic_lm_batch(TokenTaskConfig(
            vocab_size=cfg.vocab_size, seq_len=LM_GRAD_SEQ), LM_GRAD_BATCH, 0)
        b_cpu = {k: torch.from_numpy(b[k]) for k in ("tokens", "labels")}
        t = time.perf_counter()
        l_dev, g_dev = lt.loss_and_grads(
            model, tree_map(lambda x: x.to(dev), p_cpu),
            {k: v.to(dev) for k, v in b_cpu.items()})
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t
        t = time.perf_counter()
        l_cpu, g_cpu = lt.loss_and_grads(model, p_cpu, b_cpu)
        cpu_s = time.perf_counter() - t
        rel = _rel_per_leaf(g_dev, g_cpu)
        loss_rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
        worst = max(rel, key=rel.get)
        grads[arch] = {"layers": LM_GRAD_LAYERS, "batch": [
            LM_GRAD_BATCH, LM_GRAD_SEQ], "loss_rel": loss_rel,
            "max_rel": rel[worst], "worst_leaf": worst,
            "rel_per_leaf": rel, "card_s": dev_s, "cpu_s": cpu_s,
            "zero_leaves": [k for k, g in paths_and_leaves(g_cpu)
                            if not bool(g.abs().max() > 0)]}
        checks[f"{arch}_card_vs_cpu"] = max(loss_rel, rel[worst]) \
            <= LM_GRAD_LIMIT
        del g_dev, g_cpu, p_cpu, model
        gc.collect()
        torch.cuda.empty_cache()
    result["card_vs_cpu_gradients"] = grads
    sections["card_vs_cpu"] = time.perf_counter() - t_sec

    # ---- (3) the CLI killed and resumed ----------------------------------
    t_sec = time.perf_counter()
    steps, fail_at, save_every = LM_RESUME
    resume = {}
    tmp = tempfile.mkdtemp(prefix="lm_train_path_")
    try:
        for arch in LM_TRAIN_ARCHS:
            def cli(d, *extra):
                with contextlib.redirect_stdout(io.StringIO()):
                    return lt.main([
                        "--arch", arch, "--smoke", "--steps", str(steps),
                        "--batch", "4", "--seq", "64", "--save-every",
                        str(save_every), "--ckpt", os.path.join(tmp, d),
                        *extra])
            ref_state, ref_hist = cli(arch + "_a")
            killed = False
            try:
                cli(arch + "_b", "--fail-at", str(fail_at))
            except InjectedFailure:
                killed = True
            st, hist = cli(arch + "_b", "--resume", "auto")
            diff = _tree_equal(st, ref_state)
            start = fail_at - fail_at % save_every
            resume[arch] = {"steps": steps, "fail_at": fail_at,
                            "save_every": save_every, "killed": killed,
                            "resumed_steps": len(hist),
                            "loss_stream_bitwise": hist == ref_hist[start:],
                            "state_bitwise": not diff, "differs": diff[:5],
                            "losses": [h["loss"] for h in ref_hist]}
            checks[f"{arch}_resume"] = killed and not diff and \
                hist == ref_hist[start:]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["resume_smoke"] = resume
    sections["resume_smoke"] = time.perf_counter() - t_sec

    # ---- (4) the example ---------------------------------------------------
    ex = _load_example("torch_lm_train_resume")
    tmp = tempfile.mkdtemp(prefix="lm_train_path_example_")
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            exo = ex.main(["--ckpt", os.path.join(tmp, "c")])
        example_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["example"] = {"seconds": example_s, **exo,
                         "printed": buf.getvalue().strip().splitlines()[-3:]}
    checks["example"] = exo["retrained_exact"] and bool(
        exo["retrained_steps"]) and all(map(math.isfinite, exo["losses"]))

    state["launches"]["lm_train"] = ops.launch_counts()  # window ends
    result["launches"] = state["launches"]["lm_train"]
    checks["no_kernel_launched"] = not any(result["launches"].values())
    result["seconds"] = time.perf_counter() - t_phase
    result["section_seconds"] = sections
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit(result)
    require(result["ok"], f"lm_train_path: failed checks "
            f"{[k for k, v in checks.items() if not v]}")
    return result


#: lm_zoo_path: the rest of the dense zoo served at published width,
#: batch 8, prompt, decode steps, and the bytes kept free beside a
#: model's f32 weights (activations, logits, the cache) when the depth
#: is cut to what the card holds
LM_ZOO = ("starcoder2-15b", "granite-34b", "gemma-7b", "musicgen-large")
LM_ZOO_DECODE = 8
LM_ZOO_RESERVE = 8e9


def _zoo_depth(cfg, itemsize: int = 4) -> int:
    """The published depth of ``cfg``, or the most layers whose weights
    (``itemsize`` bytes each: float32 by default) fit in the card's free
    memory less ``LM_ZOO_RESERVE``. A MoE config keeps its dense prefix
    whole and cuts its MoE layers, to one at the least."""
    import torch
    from repro_torch.models import build_model
    defs = build_model(cfg).param_defs()
    size = lambda tree: itemsize * sum(math.prod(d.shape)
                                       for d in _leaves(tree))
    cut = "moe_blocks" if "moe_blocks" in defs else "blocks"
    n_cut = cfg.n_layers - (cfg.n_dense_layers if cut == "moe_blocks" else 0)
    rest = size({k: v for k, v in defs.items() if k != cut})
    free, _ = torch.cuda.mem_get_info()
    fit = int((free - LM_ZOO_RESERVE - rest) // (size(defs[cut]) / n_cut))
    return cfg.n_layers - n_cut + max(1, min(n_cut, fit))


def phase_lm_zoo_path(state: dict) -> dict:
    """The rest of the dense zoo served on the card: starcoder2-15b
    (GQA 12:1), granite-34b (MQA), gemma-7b (head dim 256, tied and
    scaled embeddings, GeGLU, vocab 256,000) and musicgen-large
    (embeddings in, no RoPE) at published widths, float32 weights from a
    seed (``wq``/``wk`` scaled by ``LM_QK_SCALE``), the published bfloat16
    stream and cache, batch ``LM_BATCH``, at published depth where the
    weights fit (``_zoo_depth``; each cut reported). Per arch: a
    cache-free ``forward`` of ``LM_PROMPT`` tokens (one flash launch a
    layer: gemma's the head-dim-256 instance), one more with every flash
    call held against the plain version, a prefill of ``LM_PROMPT`` and
    ``LM_ZOO_DECODE`` greedy decode steps (no launch), and
    ``launch.serve`` over the same config (``main --mode lm`` at
    published depth, ``serve_lm`` with the cut config otherwise)."""
    import gc
    import io
    import types

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    result: dict = {"phase": "lm_zoo_path", "stream": "bfloat16 "
                    "(published)", "cache": "bfloat16 (published)",
                    "weights": "float32", "qk_scale": LM_QK_SCALE}
    held: dict = {}
    checks: dict = {}
    ops.reset_launch_counts()  # the lm_zoo window starts here
    t_phase = time.perf_counter()
    for arch in LM_ZOO:
        published = get_config(arch)
        cfg = dataclasses.replace(published, n_layers=_zoo_depth(published))
        model = build_model(cfg)
        t = time.perf_counter()
        params = _seeded_params(model, dev, torch.float32, seed=0)
        torch.cuda.synchronize()
        r: dict = {"layers": cfg.n_layers, "published_layers":
                   published.n_layers, "d_model": cfg.d_model,
                   "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
                   "vocab": cfg.vocab_size, "input_mode": cfg.input_mode,
                   "weights_s": time.perf_counter() - t,
                   "params": sum(t_.numel() for t_ in _leaves(params))}
        g = torch.Generator(dev).manual_seed(7)
        if cfg.input_mode == "embeds":
            batch = {"embeds": torch.randn(
                (LM_BATCH, LM_PROMPT, cfg.d_model), generator=g, device=dev)}
        else:
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=g,
                device=dev)}
        with torch.no_grad():
            out, secs, launches, _, _ = launch_window(
                lambda: model.forward(params, batch))
            r["forward"] = {"seconds": secs, "launches": launches,
                            "finite": bool(torch.isfinite(out[0]).all())}
            del out
            checks[f"{arch}_forward"] = r["forward"]["finite"] and \
                launches == only_launches(flash_attention=cfg.n_layers)
            with held_against_plain(held):
                model.forward(params, batch)
            served = _lm_served(model, params, batch, LM_ZOO_DECODE)
        r["served"] = served
        checks[f"{arch}_served"] = served["finite"] and \
            served["prefill_launches"] == only_launches() and \
            served["decode_launches"] == only_launches()
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        buf = io.StringIO()
        before = ops.launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if cfg.n_layers == published.n_layers:
                argv = ["--mode", "lm", "--arch", arch, "--batch",
                        str(LM_BATCH), "--prompt-len", str(LM_PROMPT),
                        "--gen", str(LM_ZOO_DECODE + 1)]
                serve.main(argv)
            else:
                argv = f"serve_lm(cfg=<{arch} at {cfg.n_layers} layers>)"
                serve.serve_lm(types.SimpleNamespace(
                    arch=arch, smoke=False, batch=LM_BATCH,
                    prompt_len=LM_PROMPT, gen=LM_ZOO_DECODE + 1), dev,
                    cfg=cfg)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        r["launch_serve"] = {
            "argv": argv, "seconds": time.perf_counter() - t,
            "launches": {k: after[k] - before[k] for k in after},
            "printed": buf.getvalue().strip().splitlines()}
        checks[f"{arch}_launch_serve"] = any(
            ln.startswith("sample token ids:")
            for ln in r["launch_serve"]["printed"])
        gc.collect()
        torch.cuda.empty_cache()
        result[arch] = r
        emit({"progress": "lm_zoo_path", "arch": arch,
              "layers": cfg.n_layers, "forward_s": r["forward"]["seconds"],
              "prefill_s": served["prefill_s"],
              "peak_gb": served["peak_gb"]})
    state["launches"]["lm_zoo"] = ops.launch_counts()  # window ends
    state["held"]["lm_zoo"] = held
    result["launches"] = state["launches"]["lm_zoo"]
    result["depth_cuts"] = {a: [result[a]["layers"],
                                result[a]["published_layers"]]
                            for a in LM_ZOO if result[a]["layers"]
                            != result[a]["published_layers"]}
    want_flash = sum(result[a]["layers"] for a in LM_ZOO)
    checks["held"] = all(h["ok"] for h in held.values()) and held.get(
        "flash_attention", {}).get("calls") == want_flash
    result["held_against_plain"] = held
    result["seconds"] = time.perf_counter() - t_phase
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit(result)
    require(result["ok"], f"lm_zoo_path: failed checks "
            f"{[k for k, v in checks.items() if not v]}")
    return result


#: moe_path: the MoE family served at published width (batch LM_BATCH x
#: LM_PROMPT, MOE_DECODE greedy steps), the dtype of each arch's weights
#: (a float32 MoE layer of deepseek-v3 is 46 GB: not one fits beside its
#: dense prefix, embeddings and MTP module; in bfloat16, two do)
MOE_ARCHS = ("dbrx-132b", "deepseek-v3-671b")
MOE_DECODE = 16
MOE_WEIGHTS = {"dbrx-132b": "float32", "deepseek-v3-671b": "bfloat16"}
#: the consistency check: (layers, dense layers) at published width,
#: float32 weights, stream and cache
MOE_CHECK = {"dbrx-132b": (4, 0), "deepseek-v3-671b": (2, 1)}
#: the reference's capacity factor for its decode consistency test
#: (tests/test_models.py); drop-free by construction only where E / k <= 8
#: (every smoke config; dbrx-132b's 16 / 4): the gate takes
#: max(MOE_CHECK_CF, E / k), C >= S
MOE_CHECK_CF = 8.0
#: flips reported at most per check
MOE_FLIPS_SHOWN = 8


@contextlib.contextmanager
def moe_routes(record: list):
    """While active, every MoE routing decision (``moe_apply``'s top-k)
    appends ``(values, experts)`` of its k + 1 largest router
    probabilities, [B, S, k + 1] each, to ``record`` (measuring code:
    the routing itself is untouched)."""
    import torch
    from repro_torch.models import moe
    original = moe.top_k_lower_first

    def recorded(x, k):
        v, i = torch.sort(x, dim=-1, descending=True, stable=True)
        record.append((v[..., :k + 1].float().cpu(), i[..., :k + 1].cpu()))
        return original(x, k)

    moe.top_k_lower_first = recorded
    try:
        yield record
    finally:
        moe.top_k_lower_first = original


def _route_flips(fw: list, rest: list, positions, k: int) -> list:
    """Positions where ``rest``'s routing (prefill, then one decode step a
    position) chose another set of experts than the forward's, per MoE
    layer: ``(layer, row, position, forward's gap at the k-th place,
    the other path's gap)``."""
    flips = []
    for l, (fv, fi) in enumerate(fw):
        for pos in positions:
            rv, ri = rest[pos][l]
            for b in range(fi.shape[0]):
                if set(fi[b, pos, :k].tolist()) != set(ri[b, :k].tolist()):
                    flips.append((l, b, pos,
                                  float(fv[b, pos, k - 1] - fv[b, pos, k]),
                                  float(rv[b, k - 1] - rv[b, k])))
    return flips


def _moe_consistency(arch: str, cf: float) -> dict:
    """``MOE_CHECK`` layers of ``arch`` at published width, float32
    weights, stream and cache, ``capacity_factor`` ``cf``, on the card:
    the forward's last
    logits against a prefill's, and prefill(``LM_CHECK_PREFILL``) + decode
    steps to ``LM_PROMPT`` against the forward's logits at each of those
    positions, as max |diff| over the forward logits' peak. Routing is not
    continuous, so beside the gaps: every MoE layer's chosen experts in
    the forward against those of the prefill and decode steps at every
    position, each differing choice with the gap at the k-th place, and
    the forward's largest expert load against its capacity."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    n_layers, n_dense = MOE_CHECK[arch]
    pub = get_config(arch)
    # without the MTP module (the loss's alone: 2.8 GB of float32)
    cfg = dataclasses.replace(
        pub, n_layers=n_layers, n_dense_layers=n_dense, dtype=torch.float32,
        cache_dtype=torch.float32, mtp=False, moe=dataclasses.replace(
            pub.moe, capacity_factor=cf))
    model = build_model(cfg)
    params = _seeded_params(model, dev, torch.float32, seed=3)
    g = torch.Generator().manual_seed(5)
    tk = torch.randint(0, cfg.vocab_size, (2, LM_PROMPT), generator=g).to(dev)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    fw_routes, pf_routes = [], []
    dec_routes: dict = {}
    k_pf = LM_CHECK_PREFILL
    with torch.no_grad():
        with moe_routes(fw_routes):
            fw, _ = model.forward(params, {"tokens": tk})
        lg, _ = model.prefill(params, {"tokens": tk},
                              model.init_cache(2, LM_PROMPT, device=dev))
        last = rel(lg[:, 0], fw[:, -1])
        cache = model.init_cache(2, LM_PROMPT, device=dev)
        with moe_routes(pf_routes):
            lg, cache = model.prefill(params, {"tokens": tk[:, :k_pf]},
                                      cache)
        gaps = [rel(lg[:, 0], fw[:, k_pf - 1])]
        for i in range(k_pf, LM_PROMPT - 1):
            step: list = []
            with moe_routes(step):
                lg, cache = model.decode_step(params, tk[:, i:i + 1],
                                              cache, i)
            dec_routes[i] = [(v[:, 0], e[:, 0]) for v, e in step]
            gaps.append(rel(lg[:, 0], fw[:, i]))
    k = cfg.moe.top_k
    rest = {pos: [(v[:, pos], e[:, pos]) for v, e in pf_routes]
            for pos in range(k_pf)}
    rest.update(dec_routes)
    flips = _route_flips(fw_routes, rest, range(LM_PROMPT - 1), k)
    E = cfg.moe.n_experts
    loads = [int(torch.stack([torch.bincount(e[b, :, :k].reshape(-1),
                                             minlength=E)
                              for b in range(e.shape[0])]).max())
             for _, e in fw_routes]
    res = {"layers": n_layers, "dense_layers": n_dense, "batch": 2,
           "capacity_factor": cf,
           "forward_capacity": max(1, int(LM_PROMPT * k / E * cf)),
           "forward_max_expert_load": loads,
           "forward_vs_prefill_last": last,
           "prefill_then_decode_vs_forward": max(gaps),
           "decode_steps": len(gaps) - 1,
           "logits_peak": float(fw.abs().max()),
           "routing_compared": len(fw_routes) * 2 * (LM_PROMPT - 1),
           "routing_flips": len(flips),
           "flips": [{"moe_layer": l, "row": b, "position": p,
                      "forward_kth_gap": gf, "other_kth_gap": go}
                     for l, b, p, gf, go in flips[:MOE_FLIPS_SHOWN]]}
    res["drop_free"] = max(loads) <= res["forward_capacity"]
    res["ok"] = max(last, max(gaps)) <= LM_CHECK_LIMIT
    return res


def phase_moe_path(state: dict) -> dict:
    """The MoE family on the card. (1) dbrx-132b (16 experts top-4 of
    10,752, GQA 48:8 of head dim 128, every layer MoE) and
    deepseek-v3-671b (MLA with its compressed cache, 3 dense layers, 256
    experts top-8 of 2,048 and a shared one, MTP) served at published
    width with weights from a seed (``_moe_params``: dbrx float32, as the
    zoo; deepseek bfloat16, ``MOE_WEIGHTS``), the published bfloat16
    stream and cache, batch ``LM_BATCH``, at the depth the card holds
    (``_zoo_depth``: deepseek keeps its dense prefix): a cache-free
    ``forward`` of ``LM_PROMPT`` tokens (dbrx: one flash launch a layer,
    then one more forward with every flash call held against the plain
    version; MLA calls no kernel), a prefill of ``LM_PROMPT`` and
    ``MOE_DECODE`` greedy decode steps (MLA's expanded prefill and
    absorbed decode; no launch), and ``launch.serve.serve_lm`` on the cut
    config. (2) ``_moe_consistency`` for each, gated at a capacity factor
    that is drop-free by construction (``MOE_CHECK_CF``'s note);
    deepseek-v3 at ``MOE_CHECK_CF`` itself beside it, recorded (its
    forward may drop choices that a decode step keeps). (3)
    ``launch.train`` at
    smoke width on the card: the loss (with the aux and, for deepseek, the
    MTP term) finite and falling, ``--fail-at`` then ``--resume auto``
    giving the uninterrupted run's loss stream and state bit for bit.
    (4) ``launch.sample --arch dbrx-132b --smoke --combine fused``: an SA
    solve over the MoE denoiser through sa_fused and flash."""
    import gc
    import io
    import shutil
    import tempfile
    import types

    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.kernels import ops
    from repro_torch.launch import sample as launch_sample
    from repro_torch.launch import serve
    from repro_torch.launch import train as lt
    from repro_torch.models import build_model
    from repro_torch.runtime import InjectedFailure
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    result: dict = {"phase": "moe_path", "stream": "bfloat16 (published)",
                    "cache": "bfloat16 (published)", "weights": MOE_WEIGHTS,
                    "qk_scale": LM_QK_SCALE}
    held: dict = {}
    checks: dict = {}
    sections: dict = {}
    ops.reset_launch_counts()  # the moe window starts here
    t_phase = time.perf_counter()

    # ---- (1) served at published width ----------------------------------
    for arch in MOE_ARCHS:
        wdt = getattr(torch, MOE_WEIGHTS[arch])
        published = get_config(arch)
        cfg = dataclasses.replace(published, n_layers=_zoo_depth(
            published, itemsize=wdt.itemsize))
        model = build_model(cfg)
        mo = cfg.moe
        torch.cuda.synchronize()
        t = time.perf_counter()
        params = _seeded_params(model, dev, wdt, seed=0)
        torch.cuda.synchronize()
        r: dict = {"layers": cfg.n_layers, "published_layers":
                   published.n_layers, "dense_layers": cfg.n_dense_layers,
                   "d_model": cfg.d_model,
                   "attention": "mla" if cfg.mla else "gqa",
                   "heads": [cfg.n_heads, cfg.n_kv_heads],
                   "experts": {"n": mo.n_experts, "top_k": mo.top_k,
                               "d_ff": mo.d_expert_ff,
                               "shared": mo.n_shared},
                   "mtp": cfg.mtp, "vocab": cfg.vocab_size,
                   "weights": MOE_WEIGHTS[arch],
                   "weights_s": time.perf_counter() - t,
                   "params": sum(t_.numel() for t_ in _leaves(params)),
                   "weights_gb": sum(t_.numel() * t_.element_size()
                                     for t_ in _leaves(params)) / 1e9}
        g = torch.Generator(dev).manual_seed(7)
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (LM_BATCH, LM_PROMPT),
                                         generator=g, device=dev)}
        per_fwd = 0 if cfg.mla else cfg.n_layers
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            out, secs, launches, _, _ = launch_window(
                lambda: model.forward(params, batch))
            r["forward"] = {
                "seconds": secs,
                "tokens_per_s": LM_BATCH * LM_PROMPT / secs,
                "launches": launches, "aux": float(out[1]),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "finite": bool(torch.isfinite(out[0]).all())
                and math.isfinite(float(out[1]))}
            del out
            checks[f"{arch}_forward"] = r["forward"]["finite"] and \
                launches == only_launches(flash_attention=per_fwd)
            if per_fwd:
                with held_against_plain(held):
                    model.forward(params, batch)
            served = _lm_served(model, params, batch["tokens"], MOE_DECODE)
        r["served"] = served
        checks[f"{arch}_served"] = served["finite"] and \
            served["prefill_launches"] == only_launches() and \
            served["decode_launches"] == only_launches()
        # launch.serve over the cut config: dbrx draws its own float32
        # weights (the driver's init); deepseek's bfloat16 ones are passed
        # (the driver draws float32, which does not fit)
        given = None if wdt == torch.float32 else params
        del params
        gc.collect()
        torch.cuda.empty_cache()
        buf = io.StringIO()
        before = ops.launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.serve_lm(types.SimpleNamespace(
                arch=arch, smoke=False, batch=LM_BATCH,
                prompt_len=LM_PROMPT, gen=MOE_DECODE + 1), dev, cfg=cfg,
                params=given)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        r["launch_serve"] = {
            "call": f"serve_lm(cfg=<{arch} at {cfg.n_layers} layers>"
                    + (", params=<bfloat16>)" if given is not None else ")"),
            "seconds": time.perf_counter() - t,
            "launches": {k_: after[k_] - before[k_] for k_ in after},
            "printed": buf.getvalue().strip().splitlines()}
        checks[f"{arch}_launch_serve"] = any(
            ln.startswith("sample token ids:")
            for ln in r["launch_serve"]["printed"])
        del given, model
        gc.collect()
        torch.cuda.empty_cache()
        result[arch] = r
        emit({"progress": "moe_path", "arch": arch, "layers": cfg.n_layers,
              "forward_s": r["forward"]["seconds"],
              "prefill_s": served["prefill_s"],
              "decode_ms_p50": served["decode_ms_per_token_p50"],
              "peak_gb": served["peak_gb"]})
    want_flash = result["dbrx-132b"]["layers"]
    checks["held"] = all(h["ok"] for h in held.values()) and held.get(
        "flash_attention", {}).get("calls") == want_flash
    result["held_against_plain"] = held
    result["depth_cuts"] = {a: [result[a]["layers"],
                                result[a]["published_layers"]]
                            for a in MOE_ARCHS}
    sections["served"] = time.perf_counter() - t_phase

    # ---- (2) consistency at a few layers, drop-free ---------------------
    t_sec = time.perf_counter()
    result["consistency"] = {}
    for arch in MOE_ARCHS:
        mo = get_config(arch).moe
        cf = max(MOE_CHECK_CF, mo.n_experts / mo.top_k)
        c = _moe_consistency(arch, cf)
        if cf != MOE_CHECK_CF:  # recorded, not gated
            gc.collect()
            torch.cuda.empty_cache()
            c["at_reference_capacity_factor"] = _moe_consistency(
                arch, MOE_CHECK_CF)
        result["consistency"][arch] = c
        checks[f"{arch}_consistency"] = c["ok"]
        emit({"progress": "moe_path", "consistency": arch, **c})
        gc.collect()
        torch.cuda.empty_cache()
    sections["consistency"] = time.perf_counter() - t_sec

    # ---- (3) the training CLI at smoke width, killed and resumed ---------
    t_sec = time.perf_counter()
    steps, fail_at, save_every = LM_RESUME
    trained = {}
    tmp = tempfile.mkdtemp(prefix="moe_path_")
    try:
        for arch in MOE_ARCHS:
            def cli(d, *extra):
                with contextlib.redirect_stdout(io.StringIO()):
                    return lt.main([
                        "--arch", arch, "--smoke", "--steps", str(steps),
                        "--batch", "4", "--seq", "64", "--save-every",
                        str(save_every), "--ckpt", os.path.join(tmp, d),
                        *extra])
            t = time.perf_counter()
            ref_state, ref_hist = cli(arch + "_a")
            run_s = time.perf_counter() - t
            killed = False
            try:
                cli(arch + "_b", "--fail-at", str(fail_at))
            except InjectedFailure:
                killed = True
            st, hist = cli(arch + "_b", "--resume", "auto")
            diff = _tree_equal(st, ref_state)
            start = fail_at - fail_at % save_every
            cfg = get_smoke(arch)
            model = build_model(lt.train_config(cfg))
            first = next(lt.make_batches(cfg, 4, 64, dev))
            with torch.no_grad():
                after = float(model.loss_fn(ref_state["params"], first))
                _, aux = model.forward(ref_state["params"], first)
                no_mtp = float(model.loss_fn(
                    ref_state["params"],
                    {k_: first[k_] for k_ in ("tokens", "labels")}))
            losses = [h["loss"] for h in ref_hist]
            trained[arch] = {
                "steps": steps, "batch": [4, 64], "run_s": run_s,
                "losses": losses, "first_batch_loss_after": after,
                "aux_after": float(aux),
                "loss_without_labels2_after": no_mtp,
                "fail_at": fail_at, "save_every": save_every,
                "killed": killed, "resumed_steps": len(hist),
                "loss_stream_bitwise": hist == ref_hist[start:],
                "state_bitwise": not diff, "differs": diff[:5]}
            checks[f"{arch}_train"] = all(map(math.isfinite, losses)) and \
                after < losses[0] and float(aux) > 0 and \
                (after != no_mtp) == cfg.mtp
            checks[f"{arch}_resume"] = killed and not diff and \
                hist == ref_hist[start:]
            emit({"progress": "moe_path", "train_smoke": arch,
                  **trained[arch]})
            del ref_state, st, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["train_smoke"] = trained
    sections["train_smoke"] = time.perf_counter() - t_sec
    state["launches"]["moe"] = ops.launch_counts()  # window ends
    result["launches"] = state["launches"]["moe"]
    state["held"]["moe"] = held

    # ---- (4) an SA solve over the MoE denoiser ----------------------------
    t_sec = time.perf_counter()
    argv = ["--arch", "dbrx-132b", "--smoke", "--combine", "fused",
            "--nfe", str(NFE)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_sample.main(argv)  # sets the counts to 0 before its solves
    launches = ops.launch_counts()
    state["launches"]["sample_moe"] = launches
    want = get_smoke("dbrx-132b").n_layers * NFE * 2  # two solves
    result["sample"] = {"argv": argv, "launches": launches,
                        "expected_flash": want,
                        "printed": out.getvalue().strip().splitlines(),
                        "seconds": time.perf_counter() - t_sec}
    checks["sample"] = launches["flash_attention"] == want and \
        launches["sa_fused"] > 0 and launches["rwkv6_wkv"] == 0 and \
        "finite=True" in out.getvalue()
    sections["sample"] = time.perf_counter() - t_sec

    result["seconds"] = time.perf_counter() - t_phase
    result["section_seconds"] = sections
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit(result)
    require(result["ok"], f"moe_path: failed checks "
            f"{[k for k, v in checks.items() if not v]}")
    return result


#: hybrid_path: zamba2-7b (81 Mamba2 blocks, one shared attention block of
#: 32 heads of 224 applied 13 times) and qwen2-vl-2b (M-RoPE, embeddings
#: in) at published width and depth, batch LM_BATCH x LM_PROMPT,
#: HYBRID_DECODE greedy steps
HYBRID_DECODE = 16
#: the consistency checks' depths: zamba2-7b's first group of 6 Mamba
#: blocks, the shared block and one block left over (at 4 layers, its
#: period of 6 would leave no shared application); qwen2-vl-2b's 4
HYBRID_CHECK_LAYERS = {"zamba2-7b": 7, "qwen2-vl-2b": 4}
#: zamba2-7b's flash calls (B, H, K, S, T, hd, causal): the LM's forward
#: and the denoiser's (both passes)
HYBRID_FLASH_SHAPES = {"lm": (8, 32, 32, 512, 512, 224, True),
                       "denoiser": (8, 32, 32, 256, 256, 224, True)}
#: qwen2-vl-2b's prompt: a (t, h, w) grid of image patches, then text
QWEN_GRID = (2, 8, 16)


def mrope_grid_positions(batch: int, grid, n_text: int, device):
    """Qwen2-VL's three M-RoPE position streams [3, batch, S] for a prompt
    of ``t * h * w`` image patches (stream 0 the patch's frame, 1 its row,
    2 its column) followed by ``n_text`` text tokens, which count on from
    one past the largest patch position in all three streams."""
    import torch
    t, h, w = (torch.arange(n) for n in grid)
    img = torch.stack([a.reshape(-1) for a in torch.meshgrid(
        t, h, w, indexing="ij")])                             # [3, t*h*w]
    txt = int(img.max()) + 1 + torch.arange(n_text)
    pos = torch.cat([img, txt.expand(3, n_text)], dim=1)     # [3, S]
    return pos[:, None, :].expand(3, batch, pos.shape[1]).to(device)


def _served_section(arch, model, params, batch, want_flash, held, checks,
                    r) -> None:
    """``forward`` (``want_flash`` launches), one more with every flash
    call held, then prefill + ``HYBRID_DECODE`` decode steps (no launch)
    of a model at published width, recorded into ``r``."""
    import torch
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        out, secs, launches, _, _ = launch_window(
            lambda: model.forward(params, batch))
        r["forward"] = {
            "seconds": secs, "tokens_per_s": LM_BATCH * LM_PROMPT / secs,
            "launches": launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "finite": bool(torch.isfinite(out[0]).all())}
        del out
        checks[f"{arch}_forward"] = r["forward"]["finite"] and \
            launches == only_launches(flash_attention=want_flash)
        with held_against_plain(held):
            model.forward(params, batch)
        prompt = {k: v for k, v in batch.items() if k != "positions"}
        served = _lm_served(model, params, prompt, HYBRID_DECODE)
    r["served"] = served
    checks[f"{arch}_served"] = served["finite"] and \
        served["prefill_launches"] == only_launches() and \
        served["decode_launches"] == only_launches()


def _launch_serve_lm(arch, checks, r) -> None:
    """``launch.serve.main --mode lm`` at published width on the card (it
    draws its own float32 weights)."""
    import io

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--mode", "lm", "--arch", arch, "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(HYBRID_DECODE + 1)]
    buf = io.StringIO()
    before = ops.launch_counts()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    r["launch_serve"] = {
        "argv": argv, "seconds": time.perf_counter() - t,
        "launches": {k: after[k] - before[k] for k in after},
        "printed": buf.getvalue().strip().splitlines()}
    checks[f"{arch}_launch_serve"] = any(
        ln.startswith("sample token ids:")
        for ln in r["launch_serve"]["printed"])


#: the zamba2 solve's depth: 2 groups of 6 Mamba blocks, each followed
#: by the shared block, and 3 left over (the published 81 cut for the
#: script's time: at 39 layers the script took 1,192 s, PERF.md §4)
HYBRID_SOLVE_LAYERS = 15


def _zamba2_solve(checks: dict, held: dict) -> dict:
    """SA (NFE 20, P3C3 PEC, tau 1, fused) over the tame zamba2-7b
    denoiser at published width, HYBRID_SOLVE_LAYERS deep, on the
    published bfloat16 stream, latent ``SHAPE``: a cold solve (an eager
    solve, then the capture) and a replay of the compile cache's graph
    from x_T nudged by 1e-7 (the yardstick), each launching exactly 2
    passes x the shared applications x 20 flash and 19 sa_fused; an eager
    solve with the plain attention (``use_flash=False``) as the gate's
    reference, within GAP_LIMIT_BF16; one evaluation with every flash call held, and one
    under torch.profiler. The tame weights' Jacobian gain is checked on
    the float32 stream."""
    import gc

    import torch
    from repro_torch.core import Denoiser, get_schedule, make_sampler
    from repro_torch.core.samplers import eager
    from repro_torch.kernels import ops
    from repro_torch.models import Zamba2
    from repro_torch.models.tame import (ensure_contractive, tame_networks,
                                         tame_zamba2)
    dev = torch.device("cuda")
    schedule = get_schedule("vp_linear")
    t0 = time.perf_counter()
    model, params, mu = tame_zamba2("zamba2-7b", smoke=False,
                                    n_layers=HYBRID_SOLVE_LAYERS, seed=0,
                                    use_flash=True, latent=SHAPE[2],
                                    device=dev)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    cfg = model.cfg
    s = make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                     corrector_order=3, mode="PEC", combine="fused",
                     precision="f32", schedule=schedule, prediction="x0")
    g = torch.Generator(dev).manual_seed(21)
    xT = s.init_noise(g, SHAPE)
    t0 = time.perf_counter()
    contract = ensure_contractive(model, params, mu, xT, g)
    contract_s = time.perf_counter() - t0
    xis = [torch.randn(SHAPE, generator=g, device=dev)
           for _ in range(s.spec.n_steps)]
    dens = {flash: Denoiser(tame_networks(Zamba2(dataclasses.replace(
        cfg, dtype=torch.bfloat16, use_flash=flash)), params, mu)[0],
        schedule, prediction="x0") for flash in (True, False)}

    def solve(flash, x=xT):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = s.sample(dens[flash], x, noise=lambda i: xis[i])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = ops.launch_counts()
        return out, secs, {k: after[k] - before[k] for k in after}

    per_eval = 2 * cfg.n_shared_apps  # both passes
    want = only_launches(flash_attention=per_eval * s.nfe,
                         sa_fused=s.spec.n_steps)
    torch.cuda.reset_peak_memory_stats()
    out, cold, l_cold = solve(True)
    v = torch.randn(SHAPE, generator=g, device=dev)
    x_pert = xT + 1e-7 * xT.norm() / v.norm() * v
    out_n, replay, l_replay = solve(True, x=x_pert)
    peak = torch.cuda.max_memory_allocated()
    with eager():
        out_p, plain_s, l_plain = solve(False)
    tt = torch.tensor(0.5, device=dev)
    with held_against_plain(held), torch.no_grad():
        dens[True].network(xT, tt, None)
    with torch.no_grad():  # one eager evaluation, both passes
        profile = _profile_solve(lambda: dens[True].network(xT, tt, None))
    checks["zamba2_solve_launches"] = l_cold == want and l_replay == want
    checks["zamba2_solve_finite"] = bool(torch.isfinite(out).all()) and \
        tuple(out.shape) == SHAPE
    checks["zamba2_plain_solve"] = l_plain["flash_attention"] == 0
    gaps = {"flash_vs_plain_attention_bf16": rel_gap(out, out_p),
            "perturbation_yardstick_bf16": rel_gap(out_n, out)}
    checks["zamba2_solve_gap"] = \
        gaps["flash_vs_plain_attention_bf16"] <= GAP_LIMIT_BF16
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "shared_apps": cfg.n_shared_apps, "d_model": cfg.d_model,
           "shared_heads": [cfg.n_heads, cfg.n_kv_heads],
           "shared_head_dim": model.acfg.head_dim,
           "params": sum(t.numel() for t in _leaves(params)),
           "latent": list(SHAPE), "weights": "tame (float32)",
           "weights_s": weights_s, "contractive": contract,
           "contractive_s": contract_s, "stream": "bfloat16 (published)",
           "sampler": {"name": "sa", "nfe": s.nfe, "tau": 1.0,
                       "predictor_order": 3, "corrector_order": 3,
                       "mode": "PEC", "combine": "fused"},
           "cold_s": cold, "replay_s": replay,
           "plain_attention_eager_s": plain_s,
           "launches_cold": l_cold, "launches_replay": l_replay,
           "expected_launches": want, "max_memory_allocated": peak,
           "graph_pool_bytes": graph_pool_bytes(),
           "rel_gap_final": gaps, "gap_limit_bf16": GAP_LIMIT_BF16,
           "profile_one_evaluation": profile,
           "x0_minus_anchor_std": float((out.float()
                                         - mu(SHAPE[1])).std())}
    del dens, params, model, out, out_n, out_p
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_hybrid_path(state: dict) -> dict:
    """The Mamba2/Zamba2 hybrid and M-RoPE on the card. (1) zamba2-7b at
    published width and depth (81 Mamba2 blocks of d_model 3584, the
    shared block of 32 heads of 224 applied 13 times), float32 weights
    from a seed (the shared ``wq``/``wk`` scaled by ``LM_QK_SCALE``), the
    published bfloat16 stream and cache, batch ``LM_BATCH``: a cache-free
    ``forward`` of ``LM_PROMPT`` tokens (13 causal flash launches at head
    dim 224), one more with every flash call held, a prefill of
    ``LM_PROMPT`` and ``HYBRID_DECODE`` greedy decode steps (the cached
    attention and the Mamba states: no launch), ``launch.serve --mode
    lm``, and the consistency check at ``HYBRID_CHECK_LAYERS`` (float32:
    forward, prefill and decode, card and CPU). (2) ``_zamba2_solve``: SA
    over the tame zamba2-7b denoiser (HYBRID_SOLVE_LAYERS deep) through
    flash and sa_fused. (3)
    qwen2-vl-2b at published width and depth (28 layers of d_model 1536,
    12 / 2 heads of 128, embeddings in), float32 weights from a seed:
    ``forward`` over a (t, h, w) grid of image patches then text
    (``mrope_grid_positions``: 28 flash launches at GQA 6:1), held; the
    forward over three equal streams against the text-only default
    (bitwise); prefill + decode on text-only positions, ``launch.serve``
    and the 4-layer check. The launch counts are set to 0 at the start
    and read at the end."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    result: dict = {"phase": "hybrid_path", "stream": "bfloat16 "
                    "(published)", "cache": "bfloat16 (published)",
                    "weights": "float32", "qk_scale": LM_QK_SCALE}
    held: dict = {}
    checks: dict = {}
    sections: dict = {}
    ops.reset_launch_counts()  # the hybrid window starts here
    t_phase = time.perf_counter()

    for arch in ("zamba2-7b", "qwen2-vl-2b"):
        t_sec = time.perf_counter()
        cfg = get_config(arch)
        model = build_model(cfg)
        t = time.perf_counter()
        params = _seeded_params(model, dev, torch.float32, seed=0)
        torch.cuda.synchronize()
        r: dict = {"layers": cfg.n_layers, "d_model": cfg.d_model,
                   "vocab": cfg.vocab_size,
                   "weights_s": time.perf_counter() - t,
                   "params": sum(t_.numel() for t_ in _leaves(params)),
                   "weights_gb": sum(t_.numel() * t_.element_size()
                                     for t_ in _leaves(params)) / 1e9}
        g = torch.Generator(dev).manual_seed(7)
        if arch == "zamba2-7b":
            r["shared"] = {"apps": cfg.n_shared_apps,
                           "heads": [cfg.n_heads, cfg.n_kv_heads],
                           "head_dim": model.acfg.head_dim}
            batch = {"tokens": torch.randint(
                0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=g,
                device=dev)}
            want_flash = cfg.n_shared_apps
        else:
            r["heads"] = [cfg.n_heads, cfg.n_kv_heads]
            r["head_dim"] = cfg.hd
            n_img = math.prod(QWEN_GRID)
            batch = {"embeds": torch.randn(
                (LM_BATCH, LM_PROMPT, cfg.d_model), generator=g, device=dev),
                "positions": mrope_grid_positions(
                    LM_BATCH, QWEN_GRID, LM_PROMPT - n_img, dev)}
            r["positions"] = {"image_grid_thw": list(QWEN_GRID),
                              "image_tokens": n_img,
                              "text_tokens": LM_PROMPT - n_img,
                              "text_starts_at": int(
                                  batch["positions"][0, 0, n_img])}
            want_flash = cfg.n_layers
        _served_section(arch, model, params, batch, want_flash, held,
                        checks, r)
        if arch == "qwen2-vl-2b":
            with torch.no_grad():
                text = {"embeds": batch["embeds"][:2, :128]}
                same = dict(text, positions=torch.arange(
                    128, device=dev).expand(3, 2, 128))
                a, _ = model.forward(params, text)
                b, _ = model.forward(params, same)
                c, _ = model.forward(params, dict(
                    text, positions=batch["positions"][:, :2, :128]))
            r["mrope"] = {"equal_streams_vs_text_default_bitwise":
                          bool(torch.equal(a, b)),
                          "grid_vs_text_default_max_abs": float(
                              (c - a).abs().max())}
            checks["qwen2-vl-2b_mrope_streams"] = \
                r["mrope"]["equal_streams_vs_text_default_bitwise"] and \
                r["mrope"]["grid_vs_text_default_max_abs"] > 0
            del a, b, c
        del params, model, batch
        gc.collect()
        torch.cuda.empty_cache()
        _launch_serve_lm(arch, checks, r)
        gc.collect()
        torch.cuda.empty_cache()
        r["consistency"] = _lm_consistency(arch, HYBRID_CHECK_LAYERS[arch])
        checks[f"{arch}_consistency"] = r["consistency"]["ok"]
        gc.collect()
        torch.cuda.empty_cache()
        result[arch] = r
        sections[arch] = time.perf_counter() - t_sec
        emit({"progress": "hybrid_path", "arch": arch,
              "forward_s": r["forward"]["seconds"],
              "prefill_s": r["served"]["prefill_s"],
              "decode_ms_p50": r["served"]["decode_ms_per_token_p50"],
              "peak_gb": r["served"]["peak_gb"],
              "consistency": r["consistency"]})
        if arch == "zamba2-7b":
            t_sec = time.perf_counter()
            result["solve"] = _zamba2_solve(checks, held)
            sections["zamba2_solve"] = time.perf_counter() - t_sec
            emit({"progress": "hybrid_path", "solve": result["solve"]})

    state["launches"]["hybrid"] = ops.launch_counts()  # window ends
    state["held"]["hybrid"] = held
    result["launches"] = state["launches"]["hybrid"]
    # the forward's flash calls, the solve's held evaluation (both
    # passes), qwen2-vl-2b's forward
    want_held = get_config("zamba2-7b").n_shared_apps + \
        2 * result["solve"]["shared_apps"] + \
        get_config("qwen2-vl-2b").n_layers
    checks["held"] = all(h["ok"] for h in held.values()) and held.get(
        "flash_attention", {}).get("calls") == want_held
    result["held_against_plain"] = held
    result["seconds"] = time.perf_counter() - t_phase
    result["section_seconds"] = sections
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit(result)
    require(result["ok"], f"hybrid_path: failed checks "
            f"{[k for k, v in checks.items() if not v]}")
    return result


# ------------------------------------------------------------- the dry run
#: the cells the dry run's CLI counts on the (16, 16) fake mesh
DRYRUN_CELLS = (("starcoder2-3b", "train_4k"),
                ("deepseek-v3-671b", "decode_32k"),
                ("dit-xl-2", "sample_256"))
#: the DiT-XL/2 evaluation counted on the card and as fakes: [B, S]
DRYRUN_EVAL = (8, 256)
#: a predicted peak against the measured one: |predicted / measured - 1|
#: at most this. The prediction leaves out the allocator's rounding, the
#: cuBLAS workspaces and the CUDA-graph pool's blocks held over a capture
#: (PERF.md section 6 has the gaps measured: 1.2% at most)
PEAK_TOL = 0.05


def _predict_lm_train(dev) -> None:
    """``lm_train_path``'s starcoder2-3b sequence, on fake tensors on
    ``dev``: the init, the driver-init gradient and its norm, the
    tempering, and two steps (the later steps allocate as the second
    does)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as lt
    from repro_torch.models import build_model
    from repro_torch.optim import global_norm
    cfg = get_config("starcoder2-3b")
    model = build_model(lt.train_config(cfg))
    opt = lt.make_optimizer(LM_TRAIN_LR, LM_TRAIN_STEPS)
    step = lt.make_train_step(model, opt)
    batches = lt.make_batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)
    st = lt.make_init_state(model, opt, dev)()
    _, g0 = lt.loss_and_grads(model, st["params"], next(batches))
    global_norm(g0)
    del g0
    _temper_lm(st["params"])
    batches.step = 0
    first = next(batches)
    st, _ = step(st, first)
    st, _ = step(st, next(batches))


def _predict_dit_solve(dev) -> None:
    """``main_path``'s first DiT-XL/2 solve (fused, f32, NFE 20), run
    twice as the phase runs it, eager, on fake tensors on ``dev``: its
    parameters, anchor, x_T and noise made first (they were allocated
    before the phase's solve)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import Denoiser, get_schedule, make_sampler
    from repro_torch.core.samplers import eager
    from repro_torch.models import TransformerLM
    from repro_torch.models.common import abstract_params
    model = TransformerLM(dataclasses.replace(
        get_config("dit-xl-2"), dtype=torch.float32, use_flash=True))
    params = abstract_params(model.param_defs(), torch.float32, dev)
    mu = torch.empty(SHAPE[1:], device=dev)
    schedule = get_schedule("vp_linear")
    den = Denoiser(lambda x, t, c: model.denoise(params, x, t) + mu,
                   schedule, prediction="x0")
    s = make_sampler("sa", nfe=NFE, tau=1.0, predictor_order=3,
                     corrector_order=3, mode="PEC", combine="fused",
                     precision="f32", schedule=schedule, prediction="x0")
    xT = torch.empty(SHAPE, device=dev)
    xis = [torch.empty(SHAPE, device=dev) for _ in range(s.spec.n_steps)]
    with eager():
        for _ in range(2):
            s.sample(den, xT, noise=lambda i: xis[i])


#: what each prediction replays, by the name of the peak it predicts
PEAK_PREDICTIONS = {"dit_solve": _predict_dit_solve,
                    "lm_train_starcoder2-3b": _predict_lm_train}


def predict_peak(what: str, path: str) -> int:
    """``chip_smoke.py --predict-peak WHAT PATH``: the dry run's machinery
    on a one-rank fake group (``launch.dryrun.init_fake_world(1)``,
    ``op_cost.CountingFakeMode``) over ``PEAK_PREDICTIONS[what]``, on fake
    CUDA tensors: the high-water mark of live storages, written to PATH
    as JSON. No byte is allocated on the card."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch.op_cost import CountingFakeMode
    init_fake_world(1)
    t = time.perf_counter()
    mode = CountingFakeMode()
    with mode, mode.counting() as cost:
        PEAK_PREDICTIONS[what](torch.device("cuda"))
    with open(path, "w") as f:
        json.dump({"what": what, "peak_bytes": cost.peak_bytes,
                   "flops": cost.flops, "ops": cost.ops,
                   "seconds": time.perf_counter() - t}, f)
    return 0


def start_dryrun_jobs() -> dict:
    """Started before the phases, on the host's cores while the card works
    (``dryrun_path`` collects them): the dry run's CLI for each of
    ``DRYRUN_CELLS`` on the (16, 16) fake mesh, and each of
    ``PEAK_PREDICTIONS``. Each runs in a process of its own: a fake
    process group is process-wide."""
    import tempfile
    work = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    jobs = {}

    def start(name, argv, out):
        # at the lowest priority: the phases' host work comes first
        with open(os.path.join(work, f"{name}.log"), "w") as log:
            proc = subprocess.Popen(["nice", "-n", "19", *argv], env=env,
                                    cwd=ROOT, stdout=log,
                                    stderr=subprocess.STDOUT,
                                    start_new_session=True)
        jobs[name] = {"proc": proc, "out": out, "log": log.name}

    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(work, f"{arch}_{shape}.jsonl")
        start(f"{arch} x {shape}", [
            sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
            arch, "--shape", shape, "--out", out], out)
    for what in PEAK_PREDICTIONS:
        out = os.path.join(work, f"peak_{what}.json")
        start(f"peak {what}", [sys.executable, os.path.abspath(__file__),
                               "--predict-peak", what, out], out)
    return {"dir": work, "jobs": jobs, "t0": time.perf_counter()}


def stop_dryrun_jobs(jobs: dict) -> None:
    """Kill what is left of ``start_dryrun_jobs``' processes."""
    import signal
    for job in jobs["jobs"].values():
        if job["proc"].poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(job["proc"].pid, signal.SIGKILL)
            job["proc"].wait()


def _log_tail(path: str) -> str:
    with open(path) as f:
        return f.read()[-2000:]


def phase_dryrun_path(state: dict, jobs: dict) -> dict:
    """The dry run and its cost count (``launch.dryrun``, ``launch.cells``,
    ``launch.op_cost``), checked on the card.

    (a) The CLI's records of ``DRYRUN_CELLS`` on the fake (16, 16) mesh
    (started with the script): per-device GB, ``fits_80GB``, FLOPs, bytes,
    collective bytes, the dominant term. (b) One eager DiT-XL/2 evaluation
    at ``DRYRUN_EVAL`` through flash on the card under the op counter: its
    FLOPs equal the count of the same call on fake CUDA tensors; the
    counted FLOPs over the evaluation's CUDA-event time, as a share of the
    float32 peak (TF32 is off); its flash calls held against plain. (c)
    The peaks predicted on a one-rank fake group (started with the
    script) against the ones ``main_path`` and ``lm_train_path``
    measured, within ``PEAK_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.op_cost import CountingFakeMode, count_ops
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.models.common import abstract_params
    dev = torch.device("cuda")
    checks: dict = {}
    result: dict = {"phase": "dryrun_path"}

    # (a) and (c)'s predictions: the jobs started with the script
    t_wait = time.perf_counter()
    done = {}
    for name, job in jobs["jobs"].items():
        left = 600 - (time.perf_counter() - jobs["t0"])
        try:
            done[name] = job["proc"].wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            done[name] = None
    result["jobs_waited_s"] = time.perf_counter() - t_wait
    result["jobs_wall_s"] = time.perf_counter() - jobs["t0"]
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        name = f"{arch} x {shape}"
        job = jobs["jobs"][name]
        ran = done[name] == 0 and os.path.exists(job["out"])
        checks[f"cell {name} ran"] = ran
        if not ran:
            cells[name] = {"rc": done[name], "log_tail": _log_tail(job["log"])}
            continue
        with open(job["out"]) as f:
            rec = json.loads(f.read().splitlines()[-1])
        cells[name] = {
            "fake_tensors": rec["fake_tensors"], "chips": rec["chips"],
            "run_s": rec["run_s"],
            "peak_gb_per_device": rec["memory"]["peak_bytes"] / 1e9,
            "fits_80GB": rec["memory"]["fits_80GB"],
            "flops_per_device": rec["cost"]["flops_per_device"],
            "bytes_per_device": rec["cost"]["bytes_per_device"],
            "collectives": rec["collectives"],
            "collective_bytes_per_device": rec["collective_bytes_per_device"],
            "dominant": rec["roofline"]["dominant"],
            "roofline_s": {k: rec["roofline"][k] for k in
                           ("compute_s", "memory_s", "collective_s")},
            "kernels": {k: v["calls"] for k, v in
                        rec["cost"]["kernels"].items()}}
    result["cells"] = cells
    emit({"progress": "dryrun_path", "cells": cells})

    # (b) one DiT-XL/2 evaluation on the card, counted, against the fakes
    ops.reset_launch_counts()  # the dryrun window starts here
    cfg = dataclasses.replace(get_config("dit-xl-2"), dtype=torch.float32,
                              use_flash=True)
    model = TransformerLM(cfg)
    params = init_params(torch.Generator(dev).manual_seed(0),
                         model.param_defs(), torch.float32, dev)
    B, S = DRYRUN_EVAL
    g = torch.Generator(dev).manual_seed(3)
    x = torch.randn((B, S, cfg.denoiser_latent), generator=g, device=dev)
    t = torch.tensor(0.5, device=dev)
    with torch.no_grad():
        with count_ops() as counted:
            model.denoise(params, x, t)
        real = counted.cost
        mode = CountingFakeMode()
        with mode:
            fp = abstract_params(model.param_defs(), torch.float32, dev)
            fx = torch.empty((B, S, cfg.denoiser_latent), device=dev)
            ft = torch.empty((), device=dev)
            with mode.counting() as fake:
                model.denoise(fp, fx, ft)
        times = []
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model.denoise(params, x, t)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        held: dict = {}
        with held_against_plain(held):
            model.denoise(params, x, t)
    ms = statistics.median(times[1:])
    state["launches"]["dryrun"] = ops.launch_counts()  # window ends
    state["held"]["dryrun"] = held
    ev = {"batch": [B, S], "flops_real": real.flops,
          "flops_fake": fake.flops,
          "kernels_real": {k: v["calls"] for k, v in real.kernels.items()},
          "kernels_fake": {k: v["calls"] for k, v in fake.kernels.items()},
          "bytes_real": real.bytes, "bytes_fake": fake.bytes,
          "ms": ms, "ms_all": times, "tflop_per_s": real.flops / ms / 1e9,
          "share_of_f32_peak": real.flops / (ms / 1e3) / PEAK_F32_FLOP_PER_S,
          "f32_peak_flop_per_s": PEAK_F32_FLOP_PER_S,
          "held_against_plain": held}
    result["evaluation"] = ev
    checks["evaluation_flops_equal"] = real.flops == fake.flops > 0
    checks["evaluation_flash_charged"] = \
        ev["kernels_real"].get("flash_attention") == \
        ev["kernels_fake"].get("flash_attention") == cfg.n_layers
    checks["held"] = bool(held) and all(v["ok"] for v in held.values())
    del params, model

    # (c) the predicted peaks against the measured ones
    peaks = {}
    for what in PEAK_PREDICTIONS:
        job = jobs["jobs"][f"peak {what}"]
        meas = state.get("peaks", {}).get(what)
        rec = {"measured": meas}
        ok = False
        if done[f"peak {what}"] == 0 and os.path.exists(job["out"]):
            with open(job["out"]) as f:
                pred = json.load(f)
            rec["predicted_bytes"] = pred["peak_bytes"]
            rec["prediction_s"] = pred["seconds"]
            if meas is not None:
                rec["ratio"] = pred["peak_bytes"] / meas["measured_bytes"]
                ok = abs(rec["ratio"] - 1) <= PEAK_TOL
        else:
            rec["log_tail"] = _log_tail(job["log"])
        checks[f"peak {what} within {PEAK_TOL}"] = ok
        peaks[what] = rec
    result["peaks"] = peaks
    result["peak_tolerance"] = PEAK_TOL
    result["checks"] = checks
    result["ok"] = all(checks.values())
    emit(result)
    require(result["ok"], "dryrun_path checks failed: "
            f"{[k for k, v in checks.items() if not v]}")
    return result



def run_phases(state: dict, timings: dict, seconds: dict, jobs: dict) -> None:
    """Every phase in order, each one's wall seconds into ``seconds``; the
    dry run's jobs (``start_dryrun_jobs``, into ``jobs``) start once the
    kernels are built (nvcc has the host's cores until then)."""
    for name, run, emits in (
            ("build", phase_build, True),
            ("kernels", lambda: phase_kernels(timings), True),
            ("main_path", lambda: phase_main_path(state), False),
            ("profile", lambda: phase_profile(state), True),
            ("programs_path", lambda: phase_programs_path(state), False),
            ("guided_path", lambda: phase_guided_path(state), False),
            ("graph_path", lambda: phase_graph_path(state), False),
            ("serve_path", lambda: phase_serve_path(state), False),
            ("tune_path", lambda: phase_tune_path(state), False),
            ("baselines_path", lambda: phase_baselines_path(state), False),
            ("feature_cache_path", lambda: phase_feature_cache_path(state),
             False),
            ("sharded_path", lambda: phase_sharded_path(state), False),
            ("parallel_path", lambda: phase_parallel_path(state), False),
            ("sample_defaults", lambda: phase_sample_defaults(state), False),
            ("gmm", phase_gmm, False),
            ("rwkv6_path", lambda: phase_rwkv6_path(state), False),
            ("rwkv6_profile", lambda: phase_rwkv6_profile(state), True),
            ("train_path", lambda: phase_train_path(state), False),
            ("lm_path", lambda: phase_lm_path(state), False),
            ("lm_train_path", lambda: phase_lm_train_path(state), False),
            ("lm_zoo_path", lambda: phase_lm_zoo_path(state), False),
            ("moe_path", lambda: phase_moe_path(state), False),
            ("hybrid_path", lambda: phase_hybrid_path(state), False),
            ("dryrun_path", lambda: phase_dryrun_path(state, jobs), False)):
        t = time.perf_counter()
        out = run()
        seconds[name] = time.perf_counter() - t
        if emits:
            emit(out)
        if name == "build":
            jobs.update(start_dryrun_jobs())


def main() -> int:
    if sys.argv[1:2] == ["--cfg-rank"]:  # one of sharded_path's two ranks
        return sharded_cfg_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--parallel-rank"]:  # one of parallel_path's two
        return parallel_rank(int(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--predict-peak"]:  # one of dryrun_path's jobs
        return predict_peak(sys.argv[2], sys.argv[3])
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: the port's package is missing ({src}/repro_torch)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    dev = phase_device()
    emit(dev)
    timings: dict = {}
    state: dict = {"launches": {}, "held": {}}
    # each phase's wall seconds (the script has 1,200 in all)
    seconds: dict = {}
    jobs: dict = {"jobs": {}}
    try:
        run_phases(state, timings, seconds, jobs)
    finally:
        stop_dryrun_jobs(jobs)
    emit({"phase_seconds": seconds, "total": sum(seconds.values())})

    for path, names in PATH_KERNELS.items():
        missing = [k for k in names if state["launches"][path][k] == 0]
        require(not missing,
                f"kernels never launched on the {path} main path: {missing}")
    summary = []
    for name in REPLACES:
        t = timings[name]
        summary.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(n[name] for n in state["launches"].values()),
            "max_abs_err": max(h[name]["max_abs_err"]
                               for h in state["held"].values() if name in h),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"]})
    print(dev["nvidia_smi"])
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
