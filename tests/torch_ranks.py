"""Spawning gloo ranks on the CPU for the port's distributed tests.

``spawn(tmp_path, child, job, inputs, world)`` saves ``inputs`` to
``tmp_path/inputs.pt`` and runs ``python -c child job rank world tmp_path``
once per rank (``OMP_NUM_THREADS=1``, each in a session of its own), then
returns every rank's ``tmp_path/out{rank}.pt``. The whole group is killed
at the deadline. A child makes its process group from the file store
``tmp_path/store`` (:data:`PRELUDE` does it).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

#: the child's opening lines: its job, rank, world and directory, and the
#: gloo group over the file store in that directory
PRELUDE = '''
import os, sys
import torch
import torch.distributed as dist
job, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"file://{d}/store",
                        rank=rank, world_size=world)
inp = torch.load(os.path.join(d, "inputs.pt"))
'''


def spawn(tmp_path, child: str, job: str, inputs: dict, world: int = 4,
          deadline_s: float = 240.0) -> list:
    """Run ``job`` of ``child`` on ``world`` gloo ranks; every rank's
    result."""
    torch.save(inputs, tmp_path / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [SRC, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", child, job, str(r), str(world),
         str(tmp_path)], env=env, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            os.killpg(p.pid, signal.SIGKILL)
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    assert not late, f"{job}: ranks past the {deadline_s:.0f} s deadline"
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {r}:\n{log[-3000:]}"
    return [torch.load(tmp_path / f"out{r}.pt") for r in range(world)]
