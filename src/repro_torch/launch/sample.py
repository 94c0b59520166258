"""Diffusion sampling entry point of the port: any registered sampler (SA,
SEEDS or DPM-Solver++, optionally under a step program, or one of the
paper's six baselines, ``--sampler``) over a DiT, an RWKV6 or a Zamba2
backbone, or any transformer of the zoo in denoiser mode.

    PYTHONPATH=src python -m repro_torch.launch.sample --arch dit-xl-2 \
        --combine fused --weights tame
    PYTHONPATH=src python -m repro_torch.launch.sample --arch rwkv6-3b \
        --combine fused --weights tame
    PYTHONPATH=src python -m repro_torch.launch.sample --arch zamba2-7b \
        --combine fused --weights tame

Runs on the CUDA card unless ``--device cpu`` is given; with no card it
exits with an error naming the missing card. ``--nfe`` goes through
``SamplerSpec.from_nfe`` (PEC: NFE = steps + 1, PECE: 2*steps + 1; the
baselines one evaluation a step, the EDM pair two);
``--program`` stamps a preset at the largest step count whose own cost
fits ``--nfe``.
``--weights init`` samples the reference's initialisation (zero output
heads, which predict exactly 0); ``--weights tame`` the contractive
weights of ``models/tame.py`` (float32 residual stream). On the card
the transformer blocks' and Zamba2's shared attention runs through the
flash kernel and the RWKV6 recurrence through the WKV kernel (the
reference's ``use_pallas``); ``--no-flash`` / ``--no-wkv-kernel`` ask for
the plain versions there, and ``--flash`` / ``--wkv-kernel`` take the
kernels' dispatch on the CPU too (their plain versions). ``--combine kernel|fused`` runs the solver combine
through the sa_update / sa_fused kernels.

``--prediction`` serves the backbone (natively x0) in another output
convention (eps / x0 / v) through the Denoiser adapter, which converts it
back to the plan's parameterization. ``--guidance-scale`` turns on
classifier-free guidance: both branches run as one backbone call over
twice the batch. ``--cond-file`` loads a ``.npy`` conditioning array,
broadcastable to the latent ``(seq, dz)``, that the backbone takes as an
input-space prompt added to the latent (the null branch gets zeros).
``--feature-cache`` reuses the DiT's mid-stack features between solver
steps (DeepCache): ``K`` refreshes them every K-th step, ``residual:T``
when the previous step's predictor-vs-corrector residual reaches T (one
device-to-host read a step). RWKV6 and Zamba2 have no cached evaluation
and refuse it.

``--cfg-shard`` (with ``--guidance-scale``) splits the guided pair over the
size-2 ``cfg`` axis of a ``(cfg=2, data=n//2)`` mesh of the ranks that
``torchrun`` starts (each rank evaluates one branch at its lanes' batch,
one ``all_gather`` a step joins them; NCCL on the card, one card a rank,
gloo on the CPU)::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m \
        repro_torch.launch.sample --arch dit-s --smoke --batch 2 --seq 16 \
        --nfe 9 --device cpu --weights tame --guidance-scale 1.5 --cfg-shard

Run alone (one rank) it refuses, as the reference does on one device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCHS, get_config, get_smoke
from ..core import CachedNetwork, Denoiser, convert_prediction, get_schedule
from ..core.programs import list_presets, parse_program
from ..core.samplers import Sampler, SamplerSpec, get_family, list_samplers
from ..device import resolve_device
from ..distributed import world_size
from ..kernels import ops
from ..models import RWKV6Config, Zamba2Config, build_model, init_params
from ..models.tame import (ensure_contractive, tame_dit, tame_networks,
                           tame_rwkv6, tame_zamba2)
from ..serve.batching import fold_keys
from ..serve.sharding import auto_cfg_mesh

#: the spec fields each baseline family's plan reads (``ddpm_ancestral``
#: is DDIM at a fixed eta of 1; ``dpm_solver_pp_2m`` and ``edm_heun`` have
#: none)
_BASELINE_KNOBS = {"ddim": ("eta",), "euler_maruyama": ("tau",),
                   "edm_stochastic": ("s_churn", "s_tmin", "s_tmax",
                                      "s_noise")}

__all__ = ["as_cached_network", "as_prediction_network", "build_denoiser",
           "main", "parse_feature_cache"]


def _kernel_options(cfg, flash: bool | None, wkv_kernel: bool | None) -> dict:
    """The config fields the kernel flags set (None: the kernel for CUDA
    tensors), refusing a flag given for an arch it does not apply to:
    ``--flash`` to the attention archs (the transformers, Zamba2's shared
    block), ``--wkv-kernel`` to RWKV6."""
    if not isinstance(cfg, RWKV6Config):
        if wkv_kernel is not None:
            raise SystemExit("--wkv-kernel/--no-wkv-kernel apply to "
                             "rwkv6-3b only")
        return {"use_flash": flash}
    if flash is not None:
        raise SystemExit("--flash/--no-flash apply to the attention archs "
                         "only, not to rwkv6-3b")
    return {"use_kernel": wkv_kernel}


def build_denoiser(arch: str, *, smoke: bool = False, weights: str = "init",
                   flash: bool | None = None,
                   wkv_kernel: bool | None = None,
                   latent: int = 16, seed: int = 0, device="cuda"):
    """``(cfg, network, cached)`` for ``arch``: the x0-prediction network
    ``(x, t, cond) -> x0`` with weights from ``seed`` and its
    feature-cached twin (None for RWKV6 and Zamba2), on the card unless
    ``device`` says otherwise; ``cond`` is an input-space prompt added to
    the latent. ``weights="tame"`` uses the contractive construction and
    checks its Jacobian gain on the device. ``latent``
    is the latent width of an arch whose config leaves it unset.
    ``flash`` (the transformers, Zamba2) and ``wkv_kernel`` (RWKV6) pick
    the kernel (True) or the plain version (False); None takes the kernel
    for CUDA tensors."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    opts = _kernel_options(cfg, flash, wkv_kernel)
    if weights == "tame":
        tame = {RWKV6Config: tame_rwkv6, Zamba2Config: tame_zamba2}.get(
            type(cfg), tame_dit)
        model, params, mu = tame(arch, smoke=smoke, seed=seed,
                                 latent=latent, device=device, **opts)
        g = torch.Generator(device).manual_seed(seed + 3)
        x = torch.randn((1, 64, model.cfg.denoiser_latent), generator=g,
                        device=device)
        report = ensure_contractive(model, params, mu, x, g)
        if report["halvings"]:
            print(f"tame: {report['damped']} damped by {report['factor']} "
                  f"to reach Jacobian gain < 1: {report['gains']}")
        return (model.cfg, *tame_networks(model, params, mu))
    if weights != "init":
        raise ValueError(f"weights={weights!r}; expected 'init' or 'tame'")
    cfg = dataclasses.replace(
        cfg, denoiser_latent=cfg.denoiser_latent or latent, **opts)
    model = build_model(cfg)
    params = init_params(torch.Generator(device).manual_seed(seed),
                         model.param_defs(), torch.float32, device)
    # the same networks without the tame construction's mean anchor
    return (cfg, *tame_networks(model, params, lambda seq: 0.0))


def as_prediction_network(network, schedule, prediction: str):
    """An x0-prediction network ``(x, t, cond) -> x0`` re-expressed in
    ``prediction``'s convention (eps / x0 / v): the contract a real eps-
    or v-prediction checkpoint has, which the Denoiser converts back."""

    def net(x, t, cond):
        return convert_prediction(network(x, t, cond), x, t, "x0",
                                  prediction, schedule)

    return net


def as_cached_network(cached: CachedNetwork, schedule, prediction: str):
    """The feature-cached twin of :func:`as_prediction_network`."""

    def call(x, t, cond, feats, refresh):
        x0, new = cached.call(x, t, cond, feats, refresh)
        return convert_prediction(x0, x, t, "x0", prediction,
                                  schedule), new

    return CachedNetwork(call=call, init=cached.init)


def parse_feature_cache(text: str | None):
    """``"K"`` -> interval K; ``"residual:T"`` -> residual-gated with
    threshold T (the SamplerSpec.feature_cache encodings)."""
    if text is None:
        return None
    if text.startswith("residual:"):
        return ("residual", float(text.split(":", 1)[1]))
    return int(text)


def cfg_shard_mesh(device: torch.device):
    """The ``(cfg=2, data=n//2)`` mesh of ``--cfg-shard`` over the ranks
    that torchrun started (their process group is made here, from
    torchrun's environment: NCCL for the card, gloo for the CPU), or exit
    when it cannot be built; with the flag whether the group was made
    here."""
    made = False
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            if local >= torch.cuda.device_count():
                raise SystemExit(
                    f"--cfg-shard needs one card per rank (local rank "
                    f"{local}, {torch.cuda.device_count()} cards)")
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        made = True
    mesh = auto_cfg_mesh(device=device.type)
    if mesh is None:
        raise SystemExit("--cfg-shard needs an even device count >= 2 "
                         f"(have {world_size()})")
    return mesh, made


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dit-xl-2", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--sampler", default="sa", choices=list_samplers())
    ap.add_argument("--nfe", type=int, default=20)
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--predictor", type=int, default=3)
    ap.add_argument("--corrector", type=int, default=3)
    ap.add_argument("--mode", default="PEC", choices=["PEC", "PECE"])
    ap.add_argument("--program", default=None,
                    help="per-step solver program: a preset name "
                    f"({', '.join(list_presets())}), an inline JSON "
                    "object, or @path to a JSON file; assigns per-"
                    "interval predictor/corrector order, P/PEC/PECE "
                    "mode, and tau (shadows --tau/--predictor/"
                    "--corrector/--mode)")
    ap.add_argument("--grid", default="logsnr",
                    choices=["time", "logsnr", "karras"])
    ap.add_argument("--schedule", default="vp_linear")
    ap.add_argument("--prediction", default="data",
                    choices=["data", "x0", "noise", "eps", "v"],
                    help="output convention the backbone is served as (the "
                    "Denoiser converts it back)")
    ap.add_argument("--guidance-scale", type=float, default=None,
                    help="classifier-free guidance scale (both branches in "
                    "one backbone call over twice the batch)")
    ap.add_argument("--cond-file", default=None,
                    help=".npy conditioning array, broadcastable to the "
                    "latent (seq, dz)")
    ap.add_argument("--feature-cache", default=None,
                    help="DiT feature caching: an integer K (refresh the "
                    "mid-stack features every K-th solver step) or "
                    "residual:T (refresh when the previous step's "
                    "predictor-vs-corrector residual reaches T)")
    ap.add_argument("--combine", default="einsum",
                    choices=["einsum", "kernel", "fused"],
                    help="solver combine: torch.einsum, the sa_update "
                    "kernel, or the dual-output sa_fused kernel (ring "
                    "history)")
    ap.add_argument("--history", default="ring",
                    choices=["ring", "concat"],
                    help="evaluation-history layout (concat is the seed "
                    "layout that re-stacks the buffer every step)")
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--flash", action=argparse.BooleanOptionalAction,
                    help="attention (the transformers' blocks, Zamba2's "
                    "shared block) through the flash kernel (default: on "
                    "for a CUDA device)")
    ap.add_argument("--wkv-kernel", action=argparse.BooleanOptionalAction,
                    help="RWKV6 recurrence through the WKV kernel (default: "
                    "on for a CUDA device)")
    ap.add_argument("--latent", type=int, default=16,
                    help="latent width where the arch's config has none")
    ap.add_argument("--weights", default="init", choices=["init", "tame"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cfg-shard", action="store_true",
                    help="run classifier-free guidance with the cond/"
                    "uncond pair sharded over a size-2 'cfg' mesh axis "
                    "(needs --guidance-scale and >=2 ranks: torchrun "
                    "--nproc-per-node 2k) instead of the one-call "
                    "doubled-batch eval")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    mesh, made_group = None, False
    if args.cfg_shard:
        if args.guidance_scale is None:
            raise SystemExit("--cfg-shard needs --guidance-scale")
        mesh, made_group = cfg_shard_mesh(device)
    try:
        _run(args, device, mesh)
    finally:
        if made_group:
            dist.destroy_process_group()


def _run(args, device: torch.device, mesh) -> None:
    cfg, network, cached = build_denoiser(
        args.arch, smoke=args.smoke, weights=args.weights, flash=args.flash,
        wkv_kernel=args.wkv_kernel, latent=args.latent, seed=args.seed,
        device=device)
    fc = parse_feature_cache(args.feature_cache)
    if fc is not None and cached is None:
        raise SystemExit(f"--feature-cache needs a backbone with "
                         f"denoise_cached(); {cfg.name} has none")
    schedule = get_schedule(args.schedule)
    guidance = args.guidance_scale is not None
    g_scale = 1.0 if args.guidance_scale is None else args.guidance_scale
    program = None
    if args.program is not None:
        if not get_family(args.sampler).full_programs:
            raise SystemExit(
                "--program needs a family that consumes full step "
                "programs (the multistep core: sa, seeds, "
                f"dpmpp_multistep); {args.sampler!r} only honors the "
                "tau track")
        # presets are stamped at the largest step count whose own cost
        # (PECE steps evaluate twice) fits --nfe; an explicit JSON
        # program dictates its own step count through from_nfe, which
        # checks the budget again
        program = parse_program(args.program, args.nfe - 1, tau=args.tau,
                                nfe=args.nfe)
    spec = SamplerSpec.from_nfe(
        args.sampler, args.nfe, schedule=schedule, grid=args.grid,
        tau=args.tau, predictor_order=args.predictor,
        corrector_order=args.corrector, mode=args.mode,
        program=program,  # shadows the four fields above when set
        combine=args.combine, history=args.history,
        precision=args.precision, prediction=args.prediction,
        guidance=guidance, feature_cache=fc)
    sampler = Sampler(spec)
    cond = None
    if args.cond_file is not None:
        cond = torch.from_numpy(np.load(args.cond_file)).float().to(device)
    model_fn = Denoiser(
        as_prediction_network(network, schedule, args.prediction), schedule,
        prediction=args.prediction, guidance=guidance,
        # sharded: the prompt goes per lane, [batch, seq, dz]
        cond_rank=2 if mesh is not None else None,
        cached=(as_cached_network(cached, schedule, args.prediction)
                if fc is not None else None))
    g = torch.Generator(device).manual_seed(args.seed + 1)
    shape = (args.batch, args.seq, cfg.denoiser_latent)
    xT = sampler.init_noise(g, shape)

    def run(seed: int):
        if mesh is None:
            out = sampler.sample(model_fn, xT,
                                 torch.Generator(device).manual_seed(seed),
                                 cond=cond, guidance_scale=g_scale)
        else:  # one generator a lane, seeded by (seed, lane)
            gens = [torch.Generator(device).manual_seed(k)
                    for k in fold_keys(seed, range(args.batch))]
            out = sampler.sample_sharded(
                model_fn, xT, gens, mesh=mesh, data_axis="data",
                cfg_axis="cfg",
                cond=None if cond is None else torch.broadcast_to(
                    cond, shape),
                guidance_scale=torch.full((args.batch,), g_scale,
                                          device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    routed = getattr(cfg, "use_flash", getattr(cfg, "use_kernel", None))
    if routed is None:
        routed = device.type == "cuda"
    wkv = isinstance(cfg, RWKV6Config)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    x0 = run(2)
    t1 = time.perf_counter()
    run(3)
    t2 = time.perf_counter()
    multistep = get_family(args.sampler).full_programs
    if not multistep:
        # a baseline reads none of tau/P/C/mode/combine/history: print the
        # knobs its plan does read
        solver = " ".join(f"{k}={getattr(spec, k)}"
                          for k in _BASELINE_KNOBS.get(args.sampler, ()))
    elif program is not None:  # the program shadows tau/P/C/mode
        solver = f"program={args.program}"
    else:
        solver = (f"tau={args.tau} P{args.predictor}C{args.corrector} "
                  f"{args.mode}")
    # under a mesh, rank 0 prints the record (every rank holds the batch)
    say = print if mesh is None or dist.get_rank() == 0 else \
        (lambda *a: None)
    say(f"arch={cfg.name} latent={cfg.denoiser_latent} "
          f"sampler={args.sampler} "
          f"NFE={sampler.nfe} (network NFE={spec.network_nfe}) "
          f"(requested {args.nfe}) steps={spec.n_steps} "
          + (solver + " " if solver else "")
          + f"prediction={args.prediction} "
          f"guidance={g_scale if guidance else 'off'}"
          + (f" cfg_shard={tuple(mesh.mesh.shape)}" if mesh is not None
             else "")
          + (f" feature_cache={fc}" if fc is not None else "")
          + (f" combine={args.combine} history={args.history}"
             if multistep else "")
          + f" precision={args.precision} "
          f"flash={not wkv and routed} wkv_kernel={wkv and routed} "
          f"weights={args.weights} device={device}")
    finite = bool(torch.isfinite(x0).all())
    say(f"first run {t1 - t0:.2f}s, steady {t2 - t1:.2f}s; "
          f"out mean={float(x0.float().mean()):.4f} "
          f"std={float(x0.float().std()):.4f} finite={finite} "
          f"kernel launches={ops.launch_counts()}")
    if not finite:
        raise SystemExit("non-finite samples")


if __name__ == "__main__":
    main()
