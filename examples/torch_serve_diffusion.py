"""Thin client of ``repro_torch.serve``: batched diffusion serving on the
plan/execute sampler registry.

    PYTHONPATH=src python examples/torch_serve_diffusion.py --requests 12 \
        --nfe 15
    PYTHONPATH=src python examples/torch_serve_diffusion.py --device cpu \
        --requests 6 --bucket-sizes 1,2,4 --nfe 9 --stream

The reference client (``examples/serve_diffusion.py``) over the port, with
its flags and ``--device`` (the card unless ``cpu`` is asked for). The
engine does the heavy lifting: requests are bucketed by ``(SamplerSpec,
shape)``, ragged tails are padded with *masked* lanes (no duplicate
re-solves), each bucket is compiled once, and ``--stream`` attaches
per-step denoised previews from the trajectory hook. This client builds
the smoke denoiser backbone of ``--arch`` (dit-s by default; on the card
its attention runs through the flash-attention kernel), submits a mix of
requests (two tau values — same compiled executor, different coefficient
tables), and prints the engine's throughput: model-evals/s counts real
requests only, padded lanes are reported separately.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import get_schedule
from repro_torch.core.samplers import SamplerSpec, list_samplers
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_denoiser_model_fn
from repro_torch.serve import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="dit-s")
    ap.add_argument("--sampler", default="sa", choices=list_samplers())
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--bucket-sizes", type=lambda s: [int(b) for b in
                    s.split(",")], default=[1, 2, 4])
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--latent", type=int, default=8)
    ap.add_argument("--nfe", type=int, default=15)
    ap.add_argument("--tau", type=float, default=0.6)
    ap.add_argument("--stream", action="store_true",
                    help="also stream per-step denoised previews")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))

    cfg, model_fn = build_denoiser_model_fn(args.arch, args.latent,
                                            smoke=True, device=dev)

    def on_result(res):
        line = f"served rid {res.rid}: x0 {tuple(res.x0.shape)}, " \
               f"std={float(torch.std(res.x0)):.3f}"
        if res.previews is not None:
            stds = ["%.2f" % float(torch.std(p)) for p in res.previews[:6]]
            line += f", x0-preview std per step {stds}..."
        print(line)

    engine = ServeEngine(model_fn, bucket_sizes=tuple(args.bucket_sizes),
                         stream=args.stream, on_result=on_result,
                         device=dev)

    schedule = get_schedule("vp_linear")
    shape = (args.seq, cfg.denoiser_latent)
    for i in range(args.requests):
        # alternate tau: same bucket statics, different tables — the
        # engine still compiles each bucket size exactly once
        tau = args.tau if i % 2 == 0 else min(1.0, args.tau + 0.4)
        engine.submit(SamplerSpec.from_nfe(
            args.sampler, args.nfe, schedule=schedule, predictor_order=3,
            corrector_order=1, tau=tau), shape)

    results = engine.run()
    assert len(results) == args.requests
    assert all(bool(torch.isfinite(r.x0).all()) for r in results)

    s = engine.stats()
    print(f"\n{s['requests']} requests in {s['serve_s']:.2f}s over "
          f"{s['microbatches']} microbatches "
          f"({s['padded_slots']} padded lanes — masked, never counted)")
    print(f"{s['requests_per_s']:.2f} requests/s, "
          f"{s['model_evals_per_s']:.1f} model-evals/s "
          f"(NFE x real requests; sampler={args.sampler}, "
          f"arch={cfg.name})")
    print("compile cache:", s["compile_cache"])
    return {"results": results, "stats": s}


if __name__ == "__main__":
    main()
