"""Deterministic synthetic data pipelines + per-host sharded batching.

No real datasets ship with the repository; the pipelines below generate
deterministic, seeded token / latent streams with enough structure that
training makes progress (a Zipf-ish unigram mixture + an induction-head
copy pattern for tokens, a low-rank Gaussian field for latents). They are
numpy, so for the same ``(step, host)`` they give the reference's arrays
bit for bit, and a restart at step k reproduces the stream.

``ShardedBatchIterator`` splits the global batch by host: each process of
a ``torch.distributed`` group (its rank and world size; one host without
a group) materialises only its rows and places them on its ``device``.
Each rank keeps its local slice, as data-parallel PyTorch training does,
where the reference assembles one global array from the slices.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

__all__ = [
    "TokenTaskConfig", "synthetic_lm_batch", "latent_batch",
    "ShardedBatchIterator", "pack_documents",
]


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab_size: int = 1024
    seq_len: int = 256
    copy_period: int = 16      # induction structure: token repeats at lag k
    zipf_a: float = 1.2


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def synthetic_lm_batch(cfg: TokenTaskConfig, batch: int, step: int,
                       host: int = 0) -> dict:
    """Deterministic batch for (step, host): learnable structure = Zipf
    unigrams + exact copy at lag ``copy_period`` on half the positions."""
    rng = np.random.default_rng(np.random.SeedSequence([7, host, step]))
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    toks = rng.choice(cfg.vocab_size, size=(batch, cfg.seq_len + 2), p=probs)
    k = cfg.copy_period
    toks[:, k::2 * k] = toks[:, 0:-k:2 * k][:, : toks[:, k::2 * k].shape[1]]
    toks = toks.astype(np.int32)
    return {
        "tokens": toks[:, :-2],
        "labels": toks[:, 1:-1],
        "labels2": toks[:, 2:],
    }


def latent_batch(dim: int, seq: int, batch: int, step: int, host: int = 0) -> dict:
    """Continuous latent batch (denoiser training): low-rank Gaussian field
    with fixed mixing, so the score is smooth and learnable."""
    rng = np.random.default_rng(np.random.SeedSequence([13, host, step]))
    basis_rng = np.random.default_rng(13)
    B = basis_rng.normal(size=(8, seq, dim)) / np.sqrt(8)
    w = rng.normal(size=(batch, 8))
    x = np.einsum("bk,ksd->bsd", w, B) + 0.05 * rng.normal(size=(batch, seq, dim))
    return {"x0": x.astype(np.float32)}


def pack_documents(docs: list[np.ndarray], seq_len: int, pad_id: int = 0):
    """Greedy sequence packing: concatenate docs, split into seq_len rows,
    return (tokens, segment_ids) for packed-attention masking."""
    flat, seg = [], []
    for i, d in enumerate(docs):
        flat.append(d)
        seg.append(np.full(len(d), i + 1, np.int32))
    flat = np.concatenate(flat)
    seg = np.concatenate(seg)
    n = (len(flat) + seq_len - 1) // seq_len
    pad = n * seq_len - len(flat)
    flat = np.concatenate([flat, np.full(pad, pad_id, flat.dtype)])
    seg = np.concatenate([seg, np.zeros(pad, np.int32)])
    return flat.reshape(n, seq_len), seg.reshape(n, seq_len)


def _host_and_count() -> tuple[int, int]:
    """(rank, world size) of the initialised process group, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedBatchIterator:
    """Yield this host's rows of each global batch, as tensors on
    ``device`` (None: left on the CPU).

    host-sharding: each host generates rows [host_lo, host_hi) through
    ``make_host_batch(rows, step, host)`` (a dict of numpy arrays).
    Deterministic in (seed, step): restart at step k reproduces the exact
    stream; resume sets ``step``.
    """

    def __init__(self, make_host_batch, global_batch: int, device=None,
                 start_step: int = 0):
        self.make_host_batch = make_host_batch
        self.global_batch = global_batch
        self.device = device
        self.step = start_step
        self.host, self.n_hosts = _host_and_count()
        if global_batch % self.n_hosts:
            raise ValueError("global_batch must divide host count")

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rows = self.global_batch // self.n_hosts
        host_batch = self.make_host_batch(rows, self.step, self.host)
        self.step += 1
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in host_batch.items()}
