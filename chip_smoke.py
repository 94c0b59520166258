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
``examples/torch_train_denoiser.py`` on the card); the port's sampling
entry point
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
                "train": ("sa_fused", "flash_attention")}
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
    """Bytes one WKV call must move (r/k/v/logw read, y written, u and S0
    read, S_T written, once each) and the operations it does (an expf
    counts as one): the scan, the strictly-lower pairwise scores, the
    bonus term, the decays, y and the state update, per (b, h, chunk)."""
    n = B * T * H * hd
    n_bytes = 4 * n * in_bytes + 4 * n + 4 * H * hd + 2 * 4 * B * H * hd * hd
    pairs = C * (C - 1) // 2
    per_chunk = (2 * C * hd                       # L, Lprev
                 + 5 * pairs * hd                 # A: sub, exp, 2 mul, add
                 + 3 * C * hd                     # bonus
                 + 5 * C * hd                     # r exp(Lprev), k exp(Ltot-L)
                 + 2 * pairs * hd + 3 * C * hd    # A v, bonus v, sum
                 + 2 * C * hd * hd                # (r exp(Lprev)) S
                 + 2 * C * hd * hd + 3 * hd * hd)  # S update
    return n_bytes, B * H * (T // C) * per_chunk


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
#: RWKV6-3B's WKV)
NO_SPILL = {"flash_attention": "flash_kernel<f32,72>",
            "rwkv6_wkv": "wkv_kernel<64,64>"}


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
    for source, instance in NO_SPILL.items():
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
    """((least ms, what sets it), bytes) of one combine: x, xi and P
    history rows read once, ``rows`` outputs written once, the
    coefficients read once; per output row 3 + 2P flops an element."""
    n_bytes = (P + 2 + rows) * n * itemsize + rows * (P + 2) * 4
    return bound(n_bytes, rows * (2 * P + 3) * n), n_bytes


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
    out = {}
    for name, (rows, fn, plain, lib) in fns.items():
        n_bytes = (P + 2 + rows) * L * n * 4 + L * rows * (P + 2) * 4
        b_ms, by = bound(n_bytes, rows * (2 * P + 3) * L * n)
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
        *[(2, 4, 2, 96, 96, hd, True) for hd in (16, 32, 64, 72, 80, 96, 128)],
        # the edges of the kernel's 64-key tiles and 128-row query tiles
        *[(2, 4, 4, n, n, 72, causal)
          for n in (1, 63, 64, 65, 127, 128, 129) for causal in (False, True)],
        (2, 8, 2, 129, 129, 72, False),     # GQA 4:1 at a ragged edge
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
    attn_bytes, attn_ops = 4 * B * H * S * hd * 4, 4 * B * H * S * S * hd
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
                              torch.cuda.max_memory_allocated()}
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
#: configuration, in turns
GRAPH_REPEATS = 10
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
#: steady replays of each baseline in ``baselines_path`` (p50/p90)
BASELINE_REPEATS = 5
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


def _run_cfg_ranks(workdir: str) -> list:
    """Start both cfg ranks (``--cfg-rank``), each in a session of its own;
    kill both at the deadline; their results."""
    import torch
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cfg-rank", str(r),
         workdir], start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    end = time.monotonic() + SHARD_RANKS_DEADLINE_S
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
    require(not late, f"sharded: cfg ranks past {SHARD_RANKS_DEADLINE_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0,
                f"sharded: cfg rank {r} exited {p.returncode}: {log[-2000:]}")
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
    ranks = _run_cfg_ranks(workdir)
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

    # first calls of their entries: an eager solve, then the capture
    out_k32, first_f32, _ = solve(("float32", True))
    out_p32, plain_f32_s, l_plain = solve(("float32", False))
    require(l_plain["rwkv6_wkv"] == 0, "plain-WKV solve launched the kernel")
    v = torch.randn(SHAPE, generator=g, device=dev)
    x_pert = xT + 1e-7 * xT.norm() / v.norm() * v
    out_n32, _, _ = solve(("float32", True), x=x_pert)
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
              "first_call_plain_wkv_f32_stream_s": plain_f32_s,
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


def _load_example():
    """``examples/torch_train_denoiser.py`` as a module (it is loaded by
    path: ``examples/`` is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_denoiser",
        os.path.join(ROOT, "examples", "torch_train_denoiser.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree_equal(a, b) -> list:
    """Keys of the leaves of two trees that differ in a bit."""
    import torch
    from repro_torch.tree import paths_and_leaves
    bb = dict(paths_and_leaves(b))
    return [k for k, x in paths_and_leaves(a) if not torch.equal(x, bb[k])]


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
    for k in ("wq", "wk"):
        p["blocks"]["attn"][k] *= 0.3
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
    cpu_rel = {}
    dev_leaves = dict(paths_and_leaves(g_dev))
    for k, r in paths_and_leaves(g_cpu):
        scale = float(r.abs().max())
        err = float((dev_leaves[k].cpu() - r).abs().max())
        cpu_rel[k] = err / scale if scale else (0.0 if err == 0 else
                                                math.inf)

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


def main() -> int:
    if sys.argv[1:2] == ["--cfg-rank"]:  # one of sharded_path's two ranks
        return sharded_cfg_rank(int(sys.argv[2]), sys.argv[3])
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
    emit(phase_build())
    timings: dict = {}
    emit(phase_kernels(timings))
    state: dict = {"launches": {}, "held": {}}
    phase_main_path(state)
    emit(phase_profile(state))
    phase_programs_path(state)
    phase_guided_path(state)
    phase_graph_path(state)
    phase_serve_path(state)
    phase_tune_path(state)
    phase_baselines_path(state)
    phase_feature_cache_path(state)
    phase_sharded_path(state)
    phase_sample_defaults(state)
    phase_gmm()
    phase_rwkv6_path(state)
    emit(phase_rwkv6_profile(state))
    phase_train_path(state)

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
