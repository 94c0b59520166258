"""Session hooks for the PyTorch port's tests (``tests/test_torch_*.py``).

Under pytest-xdist every worker is a process of its own, and each one's
torch keeps its default intra-op thread count: the cores it sees. Six
workers on eight cores then run 48 intra-op threads that contend for the
cores, and a test that takes about a second alone takes minutes. So
before the first port test module is collected (importing it runs
torch), the worker caps torch's intra-op threads at its share of torch's
own count (not ``os.cpu_count()``, which can report the host's cores
rather than the container's). The reference's tests are left alone:
torch is imported here only when a port test module is reached, and the
cap acts on torch's thread pool alone.
"""

from __future__ import annotations

import os

_capped = False


def pytest_collectstart(collector):
    global _capped
    path = getattr(collector, "path", None)
    if _capped or path is None or not path.name.startswith("test_torch_"):
        return
    import torch

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, torch.get_num_threads() // workers))
    _capped = True
