"""Serving dispatcher of the port: one entry point for both serving
workloads.

    # LM serving (batched prefill + greedy decode against a KV/state cache):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch rwkv6-3b --smoke --batch 4 --prompt-len 32 --gen 16

    # Diffusion serving (the repro_torch.serve engine: plan-keyed
    # microbatching, warmed buckets, optional sharding + preview streaming):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode diffusion \
        --arch dit-s --sampler sa --requests 12 --nfe 15 --tau 0.6 --stream

    # ... the backbone served as a v-prediction checkpoint under
    # classifier-free guidance (the Denoiser adapter; the scale is data):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode diffusion \
        --arch dit-s --prediction v --guidance-scale 3.0 --requests 8

    # ... step-granular continuous batching, with masked early exit:
    PYTHONPATH=src python -m repro_torch.launch.serve --mode diffusion \
        --scheduler step --lanes 8 --early-exit-tol 0.02 --requests 12

    # ... by quality tier (--tuned-artifact: an autotuner winner from
    # python -m repro_torch.launch.tune as the "best" tier):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode diffusion \
        --quality-tier best --tuned-artifact artifacts/tune_nfe8.json

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
exits with an error naming the missing card. ``--mode lm`` builds the
arch's LM (``--smoke``: its reduced config) with weights from a seed,
prefills a prompt batch drawn from a seeded generator (embeddings for an
``input_mode="embeds"`` arch, musicgen-large and qwen2-vl-2b, whose decode
steps take the embedding of the token chosen; qwen2-vl's M-RoPE at the
text-only positions, as the reference leaves them), then greedy-decodes
one token a step against the cache: the model's own ``prefill`` and
``decode_step`` (the transformers, RWKV6 and Zamba2; on the card RWKV6's
prompt recurrence runs through the WKV kernel).
``--mode diffusion`` drives :class:`repro_torch.serve.ServeEngine` over
any registered sampler and a smoke backbone in denoiser mode; with
``--sharded`` the request axis rides the ``data`` axis of a mesh over the
ranks that ``torchrun`` starts (one card a rank; gloo on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke
from ..core import Denoiser, get_schedule
from ..core.samplers import SamplerSpec
from ..device import resolve_device
from ..models import build_model, init_params
from ..serve import (FaultInjector, FaultPlan, QualityTiers, ServeEngine,
                     auto_mesh, default_tiers)
from .sample import as_prediction_network

__all__ = ["serve_lm", "build_denoiser_model_fn", "build_denoiser_network",
           "serve_diffusion", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def serve_lm(args, device=None, *, cfg=None, params=None,
             batch=None) -> torch.Tensor:
    """Prefill ``args.prompt_len`` tokens x ``args.batch``, then greedy
    decode ``args.gen`` tokens; prints the reference's two lines and
    returns the generated ids [batch, gen]. ``cfg``, ``params`` and the
    prompt ``batch`` (``{"tokens"}`` or ``{"embeds"}``) replace the arch's
    config, the seeded weights and the seeded prompt."""
    device = resolve_device("cuda" if device is None else device)
    if cfg is None:
        cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    if params is None:
        params = init_params(torch.Generator(device).manual_seed(0),
                             model.param_defs(), torch.float32, device)

    B, S = args.batch, args.prompt_len
    s_max = S + args.gen
    embeds_mode = getattr(cfg, "input_mode", "tokens") == "embeds"
    if batch is None:
        g = torch.Generator(device).manual_seed(1)
        if embeds_mode:
            batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=g,
                                           device=device)}
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                             generator=g, device=device)}

    cache = model.init_cache(B, s_max, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache)
    _sync(device)
    t1 = time.perf_counter()

    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    out = [tok]
    for i in range(args.gen - 1):
        if embeds_mode:
            step_in = params["embed"][tok] if "embed" in params else \
                torch.zeros((B, 1, cfg.d_model), device=device)
        else:
            step_in = tok
        logits, cache = model.decode_step(params, step_in, cache, S + i)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        out.append(tok)
    toks = torch.cat(out, dim=1)
    _sync(device)
    t2 = time.perf_counter()
    print(f"arch={cfg.name} prefill {S} toks x{B}: {t1-t0:.3f}s; "
          f"decode {args.gen} steps: "
          f"{(t2-t1)/max(args.gen-1,1)*1e3:.1f} ms/tok")
    print("sample token ids:", toks[0][:12].tolist())
    return toks


def _denoiser_model(arch: str, latent: int | None, smoke: bool, device):
    """(cfg, model, params): any arch in denoiser mode (latent width
    ``latent or 8`` where the config has none), weights from seed 0."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    if getattr(cfg, "denoiser_latent", None) is None:
        cfg = dataclasses.replace(cfg, denoiser_latent=latent or 8)
    model = build_model(cfg)
    params = init_params(torch.Generator(device).manual_seed(0),
                         model.param_defs(), torch.float32, device)
    return cfg, model, params


def build_denoiser_model_fn(arch: str, latent: int | None, smoke: bool,
                            device="cuda"):
    """(cfg, lane-batched model_fn) for an arch in denoiser mode: the
    engine calls ``model_fn(x [L, seq, dz], t [L])`` over its stacked
    lanes (the reference's per-request closure is vmapped instead)."""
    cfg, model, params = _denoiser_model(arch, latent, smoke,
                                         resolve_device(device))
    return cfg, lambda x, t: model.denoise(params, x, t)


def build_denoiser_network(arch: str, latent: int | None, smoke: bool,
                           schedule, prediction: str, device="cuda"):
    """(cfg, Denoiser-contract network): the lane-batched backbone
    re-expressed as an eps/x0/v ``(x, t, cond)`` network, ``cond``
    consumed as an input-space prompt added to the latent (the zoo
    backbones are unconditional)."""
    cfg, model, params = _denoiser_model(arch, latent, smoke,
                                         resolve_device(device))

    def network(x, t, cond):
        return model.denoise(params, x if cond is None else x + cond, t)

    return cfg, as_prediction_network(network, schedule, prediction)


def _serving_mesh(device: torch.device):
    """The ``--sharded`` mesh over the ranks torchrun started (their
    process group made here from its environment: NCCL on the card, gloo
    on the CPU), or None at one rank; with whether the group was made
    here."""
    made = False
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        made = True
    return auto_mesh(device=device.type), made


def serve_diffusion(args, device=None) -> None:
    device = resolve_device("cuda" if device is None else device)
    mesh, made_group = _serving_mesh(device) if args.sharded else (None,
                                                                    False)
    if args.sharded and mesh is None:
        print("--sharded: only one rank, falling back to the unsharded "
              "path (start the ranks with torchrun --nproc-per-node N to "
              "shard the requests)")
    try:
        _serve_diffusion(args, device, mesh)
    finally:
        if made_group:
            dist.destroy_process_group()


def _serve_diffusion(args, device: torch.device, mesh) -> None:
    # under a mesh every rank serves every request; rank 0 prints
    say = print if mesh is None or dist.get_rank() == 0 else \
        (lambda *a: None)
    schedule = get_schedule("vp_linear")
    guidance = args.guidance_scale is not None
    adapted = guidance or args.prediction != "data" \
        or args.cond_file is not None
    if adapted:
        cfg, network = build_denoiser_network(
            args.arch, args.latent, True, schedule, args.prediction, device)
        # a request's prompt is one latent, [seq, dz]
        model_fn = Denoiser(network, schedule, prediction=args.prediction,
                            guidance=guidance, cond_rank=2)
    else:
        cfg, model_fn = build_denoiser_model_fn(args.arch, args.latent,
                                                True, device)
    cond = None
    if args.cond_file is not None:
        cond = torch.from_numpy(np.load(args.cond_file)).float().to(device)

    def show(res):
        if res.previews is not None:
            stds = [float(torch.std(p)) for p in res.previews[:6]]
            say(f"  stream rid {res.rid}: x0-preview std per step "
                  f"{['%.2f' % s for s in stds]}...")

    tiers = None
    if args.quality_tier is not None:
        tiers = QualityTiers.from_artifact(args.tuned_artifact) \
            if args.tuned_artifact else default_tiers(
                family=args.tier_family, schedule=schedule)
        if adapted:  # tiers carry solver choices; serving adapter fields
            tiers = QualityTiers({  # (prediction/guidance) come from flags
                name: dataclasses.replace(
                    s, prediction=args.prediction, guidance=guidance)
                for name, s in tiers.specs.items()})
    injector = None
    if args.inject and not args.guard_interval:
        args.guard_interval = 4  # injecting NaNs without the guard
        # would let them reach results marked "ok"
    if args.inject:
        # a small deterministic chaos mix: one NaN'd lane, one raised
        # tick, one latency spike — seeded so reruns replay it exactly
        injector = FaultInjector(FaultPlan.seeded(
            0, n_ticks=max(2, args.requests), rids=range(args.requests)))
    degrade_ladder = None
    if args.degrade_ladder:
        degrade_ladder = [s.strip() for s in args.degrade_ladder.split(",")
                          if s.strip()]
    engine = ServeEngine(
        model_fn, bucket_sizes=tuple(args.bucket_sizes), mesh=mesh,
        stream=args.stream, on_result=show if args.stream else None,
        tiers=tiers, scheduler=args.scheduler, lanes=args.lanes,
        max_retries=args.max_retries, degrade_ladder=degrade_ladder,
        guard_interval=args.guard_interval, fault_injector=injector,
        device=device)
    if args.quality_tier is not None:
        spec, submit_kw = None, {"quality_tier": args.quality_tier}
    else:
        spec = SamplerSpec.from_nfe(
            args.sampler, args.nfe, schedule=schedule,
            predictor_order=3, corrector_order=1, tau=args.tau,
            prediction=args.prediction if adapted else None,
            guidance=guidance)
        submit_kw = {}
    shape = (args.seq, cfg.denoiser_latent)
    g_scale = 1.0 if args.guidance_scale is None else args.guidance_scale
    for _ in range(args.requests):
        engine.submit(spec, shape, cond=cond, guidance_scale=g_scale,
                      early_exit_tol=args.early_exit_tol, **submit_kw)
    if spec is None:
        spec = engine.tiers.resolve(args.quality_tier)
        say(f"quality tier {args.quality_tier!r} -> "
              f"{spec.name} NFE {spec.nfe}, {spec.n_steps} steps"
              + (" (tuned artifact)" if args.tuned_artifact else ""))

    results = engine.run()
    if len(results) != args.requests:
        raise SystemExit(f"served {len(results)} of {args.requests} "
                         "requests")
    for res in results:
        if res.status == "ok" and not bool(torch.isfinite(res.x0).all()):
            raise SystemExit(f"rid {res.rid}: non-finite result")
    bad = [r for r in results if r.status != "ok"]
    if bad or args.inject:
        h = engine.health()
        say(f"health: {h['status']} (completed={h['completed']}, "
              f"failed={h['failed']}, "
              f"failed_numerics={h['failed_numerics']}, "
              f"retries={h['retries']}, shed={h['shed']}, "
              f"quarantines={h['quarantines']})")
        for r in bad:
            say(f"  rid {r.rid}: {r.status} after {r.attempts} "
                  f"attempt(s)"
                  + (f" [{r.degraded_to}]" if r.degraded_to else "")
                  + (f" — {r.error}" if r.error else ""))
        if injector is not None:
            say(f"injected: {injector.fired}")
    s = engine.stats()
    mesh_desc = "none" if mesh is None else dict(
        zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if args.scheduler == "step":
        say(f"\nserved {s['completed']} requests in {s['serve_s']:.2f}s "
              f"({s['joins']} lane joins, {s['migrations']} migrations, "
              f"{s['shed']} shed, {s['ticks']} ticks, "
              f"{s['warmups']} step-fn compiles)")
        say(f"{s['requests_per_s']:.2f} requests/s, "
              f"{s['model_evals_per_s']:.1f} model-evals/s "
              f"(sampler={args.sampler}, arch={cfg.name}, "
              f"prediction={args.prediction}, "
              f"guidance={args.guidance_scale if guidance else 'off'}, "
              f"early_exit_tol={args.early_exit_tol})")
        for label, b in s["buckets"].items():
            say(f"  bucket {label}: occupancy {b['occupancy']:.2f} "
                  f"({b['wasted_lane_steps']} wasted lane-steps over "
                  f"{b['ticks']} ticks)")
        say("stepwise cache:", s["stepwise_cache"])
    else:
        say(f"\nserved {s['requests']} requests in {s['serve_s']:.2f}s "
              f"over {s['microbatches']} microbatches ({s['padded_slots']} "
              f"padded lanes, {s['warmups']} bucket compiles, "
              f"mesh={mesh_desc})")
        say(f"{s['requests_per_s']:.2f} requests/s, "
              f"{s['model_evals_per_s']:.1f} model-evals/s, "
              f"{s['network_evals_per_s']:.1f} network-evals/s "
              f"(NFE={spec.nfe}, network NFE={spec.network_nfe} x real "
              f"requests only; sampler={args.sampler}, arch={cfg.name}, "
              f"prediction={args.prediction}, "
              f"guidance={args.guidance_scale if guidance else 'off'})")
        say("compile cache:", s["compile_cache"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", default="lm", choices=["lm", "diffusion"])
    ap.add_argument("--arch", default=None,
                    help="arch (default: starcoder2-3b for lm, dit-s for "
                    "diffusion)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    # lm
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    # diffusion
    ap.add_argument("--sampler", default="sa")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--latent", type=int, default=None)
    ap.add_argument("--nfe", type=int, default=15)
    ap.add_argument("--tau", type=float, default=0.6)
    ap.add_argument("--bucket-sizes", type=lambda s: [int(b) for b in
                    s.split(",")], default=[1, 2, 4, 8],
                    help="comma-separated microbatch lane counts")
    ap.add_argument("--stream", action="store_true",
                    help="stream per-step denoised previews")
    ap.add_argument("--scheduler", default="solve",
                    choices=["solve", "step"],
                    help="'solve' batches whole solves per microbatch; "
                    "'step' is the continuous batcher — requests join and "
                    "leave running batches at step boundaries")
    ap.add_argument("--lanes", type=int, default=8,
                    help="lane count per running batch (step scheduler)")
    ap.add_argument("--early-exit-tol", type=float, default=0.0,
                    help="masked early exit on the predictor-vs-corrector "
                    "residual (step scheduler; <=0 disables, keeping the "
                    "exact whole-solve trajectory)")
    ap.add_argument("--sharded", action="store_true",
                    help="place the request axis on a mesh data axis over "
                    "the ranks torchrun starts")
    ap.add_argument("--prediction", default="data",
                    choices=["data", "x0", "noise", "eps", "v"],
                    help="serve the backbone as this checkpoint "
                    "convention (the denoiser adapter converts it)")
    ap.add_argument("--guidance-scale", type=float, default=None,
                    help="classifier-free guidance scale for every "
                    "request (the scale is data: per-request sweeps "
                    "reuse one graph)")
    ap.add_argument("--cond-file", default=None,
                    help=".npy per-request conditioning, broadcastable "
                    "to the latent")
    ap.add_argument("--quality-tier", default=None,
                    help="submit by tier name (draft|standard|best with "
                    "the default ladder) instead of --sampler/--nfe/--tau")
    ap.add_argument("--tuned-artifact", default=None,
                    help="repro_torch.launch.tune JSON artifact; its "
                    "searched winner becomes the 'best' tier (and its "
                    "feature-cache winner, if recorded, the 'draft' tier)")
    ap.add_argument("--tier-family", default="sa",
                    help="sampler family the default tier ladder is "
                    "built over (a multistep-core family: sa, seeds, "
                    "dpmpp_multistep); ignored with --tuned-artifact")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="serve attempts beyond the first for a failed "
                    "request (guard trip or host fault); each retry "
                    "draws fresh noise")
    ap.add_argument("--degrade-ladder", default=None,
                    help="comma-separated retry fallback rungs: tier "
                    "names and/or 'tau0' (same spec at tau=0, the "
                    "deterministic ODE limit), e.g. 'standard,tau0'")
    ap.add_argument("--guard-interval", type=int, default=0,
                    help="per-lane finiteness check every N solver steps "
                    "(step scheduler; carried as data — no new graphs); "
                    "any non-zero value also enables the solve "
                    "scheduler's post-solve check. 0 disables")
    ap.add_argument("--inject", action="store_true",
                    help="chaos smoke: seeded fault mix (1 NaN lane, 1 "
                    "raised tick, 1 latency spike) through the serve "
                    "path; implies --guard-interval 4 if unset")
    args = ap.parse_args(argv)
    if args.arch is None:
        args.arch = "starcoder2-3b" if args.mode == "lm" else "dit-s"
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    if args.mode == "lm":
        serve_lm(args, device)
    else:
        serve_diffusion(args, device)


if __name__ == "__main__":
    main()
