"""Program-autotuner driver of the port: search StepProgram space from
the CLI.

    # budgeted GMM-oracle search at NFE 8, checkpointed + resumable:
    PYTHONPATH=src python -m repro_torch.launch.tune \
        --nfe 8 --budget 4000 --seed 0 --artifact artifacts/tune_nfe8.json

    # interrupt-friendly: run two units now, the rest later
    PYTHONPATH=src python -m repro_torch.launch.tune \
        --artifact artifacts/tune_nfe8.json --resume --max-units 2

    # tune a baseline family's per-step eta (tau track) instead:
    PYTHONPATH=src python -m repro_torch.launch.tune --family ddim --nfe 10

    # on the CPU (without --device cpu it stops when there is no card):
    PYTHONPATH=src python -m repro_torch.launch.tune --device cpu \
        --nfe 8 --budget 200

Runs on the CUDA card unless ``--device cpu`` is given: each chunk of
candidates is one candidate-stacked solve through the combine kernels'
lane entries (``--chunk`` candidates x ``--n-seeds`` lanes), one CUDA
graph per mode pattern.

The JSON artifact records the echoed config, the serialized search RNG,
the unit cursor, the full eval history, and the best program — resuming
replays bit-identically, and serving loads the winner directly::

    tiers = repro_torch.serve.QualityTiers.from_artifact(
        "artifacts/tune_nfe8.json")

The artifact format is the reference's (``repro.launch.tune``): each
package reads the other's artifacts.
"""

import argparse
import json

from ..device import resolve_device
from ..tune import SearchConfig, run_search


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--family", default="sa",
                    help="sampler family to tune: multistep-core "
                    "families (sa, seeds, dpmpp_multistep) search full "
                    "order/mode/tau programs; baselines (ddim, "
                    "ddpm_ancestral, euler_maruyama, edm_stochastic) "
                    "search the tau track only")
    ap.add_argument("--schedule", default="vp_linear")
    ap.add_argument("--nfe", type=int, default=8,
                    help="model-evaluation budget per solve")
    ap.add_argument("--budget", type=int, default=4000,
                    help="total search spend in NFE-equivalents "
                    "(nfe x n_seeds per candidate)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--presets", default=None,
                    help="comma-separated warm-start presets (default: "
                    "per-family)")
    ap.add_argument("--tau", type=float, default=1.0)
    ap.add_argument("--n-samples", type=int, default=512,
                    help="GMM-oracle sample-set size per solve")
    ap.add_argument("--n-seeds", type=int, default=4,
                    help="independent solves averaged per candidate")
    ap.add_argument("--chunk", type=int, default=16,
                    help="candidates per device dispatch")
    ap.add_argument("--cd-passes", type=int, default=2)
    ap.add_argument("--evo-population", type=int, default=12)
    ap.add_argument("--evo-generations", type=int, default=3)
    ap.add_argument("--fc-thresholds", default=None,
                    help="comma-separated residual feature-cache "
                    "thresholds; enables a final search unit over the "
                    "(tau, threshold) plane whose winner — the largest "
                    "threshold scoring within --fc-slack of the program "
                    "winner — lands in the artifact as best_fc")
    ap.add_argument("--fc-slack", type=float, default=1.25,
                    help="quality-slack factor for the feature-cache "
                    "winner selection")
    ap.add_argument("--artifact", default=None,
                    help="JSON checkpoint path (written at every unit "
                    "boundary)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --artifact if it exists (its "
                    "echoed config wins over the flags above)")
    ap.add_argument("--max-units", type=int, default=None,
                    help="stop after this many mode-pattern units "
                    "(state stays resumable)")
    ap.add_argument("--device", default="cuda",
                    help="where the solves run: the CUDA card by default "
                    "(raises without one), or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    config = SearchConfig(
        family=args.family, nfe=args.nfe, budget=args.budget,
        seed=args.seed,
        presets=tuple(args.presets.split(",")) if args.presets else (),
        tau=args.tau, n_samples=args.n_samples, n_seeds=args.n_seeds,
        chunk=args.chunk, cd_passes=args.cd_passes,
        evo_population=args.evo_population,
        evo_generations=args.evo_generations,
        fc_thresholds=(tuple(float(v) for v in
                             args.fc_thresholds.split(","))
                       if args.fc_thresholds else ()),
        fc_slack=args.fc_slack,
        spec_kw={"schedule": args.schedule})

    result = run_search(config, artifact=args.artifact, resume=args.resume,
                        max_units=args.max_units, log=print,
                        device=device)

    s = result.state
    print(f"\nsearched {len(s['history'])} evaluations, "
          f"{s['budget_spent']}/{SearchConfig.from_obj(s['config']).budget} "
          f"NFE-equivalents spent "
          f"({result.stats['dispatches']} dispatches, "
          f"{result.stats['compiles']} executor compiles)")
    if result.best_program is None:
        print("no candidate evaluated (budget too small?)")
        return
    print(f"best score: {result.best_score:.5f}")
    print("best program:",
          json.dumps(json.loads(result.best_program.to_json()), indent=1))
    if result.best_fc is not None:
        fc = result.best_fc
        print(f"best feature-cache: thresh={fc['thresh']:g} "
              f"tau={fc['tau']:g} score={fc['score']:.5f} "
              f"(anchor {fc['anchor']:.5f}, slack {fc['slack']:g})")
    if args.artifact:
        print(f"artifact: {args.artifact} "
              f"({'complete' if result.done else 'resumable'})")


if __name__ == "__main__":
    main()
