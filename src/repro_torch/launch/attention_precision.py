"""How far each float32 attention of a DiT solve sits from the exact answer.

    PYTHONPATH=src python -m repro_torch.launch.attention_precision
    PYTHONPATH=src python -m repro_torch.launch.attention_precision \
        --arch dit-s --smoke --batch 2 --seq 16 --nfe 4 --device cpu

Runs one SA solve (P3C3 PEC, tau 1, fused combine, f32) of a DiT with the
contractive weights of ``models/tame.py`` and attention through the flash
kernel. Every attention call is also computed by the plain version, by
``scaled_dot_product_attention`` (SDPA) and in float64. Prints one JSON
line: per pair of them, the largest |difference| and the calls over the
card-side attention tolerance 2e-5 max(1, max|second|); the calls; the
largest |logit| and |v|. On a CPU tensor the "kernel" is the plain
version. Information only: it checks nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math

import torch

from ..configs import ARCHS
from ..core import Denoiser, get_schedule
from ..core.samplers import Sampler, SamplerSpec, eager
from ..device import resolve_device
from ..kernels import ops
from .sample import build_denoiser

__all__ = ["PAIRS", "attention_f64", "recording", "main"]

PAIRS = ("kernel_vs_plain", "kernel_vs_f64", "plain_vs_f64",
         "sdpa_vs_plain", "sdpa_vs_f64")


def attention_f64(q, k, v, causal: bool):
    """(attention of ``q, k, v`` computed in float64, the largest finite
    |logit|)."""
    G = q.shape[1] // k.shape[1]
    k = k.double().repeat_interleave(G, 1)
    v = v.double().repeat_interleave(G, 1)
    s = torch.einsum("bhsd,bhtd->bhst", q.double(), k) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool,
                                     device=s.device).triu(1), -math.inf)
    out = torch.einsum("bhst,bhtd->bhsd", torch.softmax(s, -1), v)
    return out, float(s[s.isfinite()].abs().max())


@contextlib.contextmanager
def recording(record: dict):
    """While active, every ``ops.flash_attention`` call is also computed by
    the plain version, by SDPA and in float64, and ``record`` keeps the
    figures :func:`main` prints."""
    orig = ops.flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    record.update(calls=0, max_abs_logit=0.0, max_abs_v=0.0,
                  **{p: {"max_abs_err": 0.0, "over_tolerance": 0}
                     for p in PAIRS})

    def probe(q, k, v, *, causal=True, mode="auto"):
        out = orig(q, k, v, causal=causal, mode=mode)
        f64, logit = attention_f64(q, k, v, causal)
        got = {"kernel": out,
               "plain": orig(q, k, v, causal=causal, mode="plain"),
               "sdpa": sdpa(q, k, v, is_causal=causal, enable_gqa=True),
               "f64": f64}
        record["calls"] += 1
        record["max_abs_logit"] = max(record["max_abs_logit"], logit)
        record["max_abs_v"] = max(record["max_abs_v"], float(v.abs().max()))
        for p in PAIRS:
            a, b = (got[n].double() for n in p.split("_vs_"))
            err = float((a - b).abs().max())
            r = record[p]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["over_tolerance"] += err > 2e-5 * max(1.0, float(b.abs().max()))
        return out

    ops.flash_attention = probe
    try:
        yield record
    finally:
        ops.flash_attention = orig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dit-xl-2",
                    choices=[a for a in ARCHS if a.startswith("dit")])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--nfe", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    cfg, network, _ = build_denoiser(args.arch, smoke=args.smoke,
                                     weights="tame", flash=True,
                                     seed=args.seed, device=device)
    schedule = get_schedule("vp_linear")
    sampler = Sampler(SamplerSpec.from_nfe(
        "sa", args.nfe, schedule=schedule, tau=1.0, predictor_order=3,
        corrector_order=3, mode="PEC", combine="fused", precision="f32",
        prediction="x0"))
    g = torch.Generator(device).manual_seed(args.seed + 1)
    xT = sampler.init_noise(g, (args.batch, args.seq, cfg.denoiser_latent))
    record: dict = {"arch": cfg.name, "latent": list(xT.shape),
                    "nfe": sampler.nfe, "device": str(device)}
    # eager: the recording reads every flash call back, which a CUDA graph
    # capture cannot hold
    with recording(record), eager():
        out = sampler.sample(Denoiser(network, schedule, prediction="x0"),
                             xT, g)
    record["finite"] = bool(torch.isfinite(out).all())
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
