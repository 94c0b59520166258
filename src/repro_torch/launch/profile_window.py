"""Compare the DiT-XL/2 profiler window of checkouts on one card.

For each checkout root given, in the order given, a fresh process runs
that checkout's ``chip_smoke.py`` build phase, its DiT-XL/2 main path and
then its profile phase ``--repeats`` times, and prints one JSON line: the
main path's steady fused-f32 solve, and for each repeat the profiled wall,
device busy time, idle share and the Python garbage collections inside
the phase; then the host operations with the most self CPU time in one
more profiled solve. Give the roots in turns (A B B A) to compare two
commits on the same card:

    python -m repro_torch.launch.profile_window ROOT_A ROOT_B ROOT_B ROOT_A

Needs a CUDA card; each root builds its own kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import gc, json, sys, time
sys.path[:0] = ["src", "."]
import chip_smoke as c
c.phase_build()
state = {"launches": {}, "held": {}}
main = c.phase_main_path(state)
tame = state["tame"]  # an older phase_profile pops it
gc_stats = {"n": 0, "ms": 0.0, "t": 0.0}
def _gc(phase, info):
    if phase == "start":
        gc_stats["t"] = time.perf_counter()
    else:
        gc_stats["n"] += 1
        gc_stats["ms"] += (time.perf_counter() - gc_stats["t"]) * 1e3
gc.callbacks.append(_gc)
reps = []
for _ in range(REPEATS):
    gc_stats.update(n=0, ms=0.0)
    state["tame"] = tame
    p = c.phase_profile(state)
    reps.append({k: p[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                   "backbone_eval_ms")}
                | {"gc_collections": gc_stats["n"], "gc_ms": gc_stats["ms"]})
gc.callbacks.remove(_gc)

import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core import Denoiser, make_sampler
from repro_torch.models.tame import tame_networks
model, params, mu, schedule = tame
s = make_sampler("sa", nfe=c.NFE, tau=1.0, combine="fused",
                 schedule=schedule, prediction="x0")
net = tame_networks(model, params, mu)
# (network, cached) from the feature-cache slice on; the network before it
net = net[0] if isinstance(net, tuple) else net
den = Denoiser(net, schedule, prediction="x0")
g = torch.Generator("cuda").manual_seed(1)
xT = s.init_noise(g, c.SHAPE)
s.sample(den, xT, g)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    s.sample(den, xT, g)
    torch.cuda.synchronize()
host = sorted(((e.self_cpu_time_total / 1e3, e.key[:60], e.count)
               for e in prof.key_averages()), reverse=True)[:12]
print("PROFILE_WINDOW " + json.dumps({
    "steady_fused_f32_s": main["runs"]["fused_f32"]["steady_s"],
    "repeats": reps,
    "host_self_cpu_ms": [{"ms": ms, "op": k, "calls": n}
                         for ms, k, n in host]}), flush=True)
"""


def run_root(root: str, repeats: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.replace("REPEATS", str(repeats))],
        cwd=root, env=env, capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("PROFILE_WINDOW ")]
    if proc.returncode or not lines:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1].split(" ", 1)[1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, in run order")
    ap.add_argument("--repeats", type=int, default=3,
                    help="profile phases per process (default 3)")
    args = ap.parse_args(argv)
    for i, root in enumerate(args.roots):
        out = run_root(os.path.abspath(root), args.repeats)
        print(json.dumps({"run": i, "root": root, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
