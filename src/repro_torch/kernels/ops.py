"""Dispatch for the port's kernels.

``mode="auto"`` (the default): a CPU tensor takes the kernel's plain
PyTorch version; any other tensor goes to the hand-written Hopper kernel,
which launches on a CUDA tensor or raises. There is no fallback from the
kernel to the plain version. ``mode="plain"`` forces the plain version on
any device (tests, and the card-side comparisons in ``chip_smoke.py``).

A fake or meta tensor (``torch._subclasses.fake_tensor``, the dry run's
``launch.dryrun``), in either mode, takes the abstract branch and no
other: outputs of the kernel's contract shapes and dtypes that hold no
data, with the kernel's own cost (its module's ``cost``) charged to the
active counters (``scope.charge_kernel``). It never runs the plain
version, whose intermediates (flash's [B, H, S, T] scores) the kernel
never writes. A DTensor of fake shards is taken shard by shard: the dims
a kernel computes independently (the batch, the heads; any dim of a
combine) stay sharded, any other sharded dim is gathered first. A
kernel launch charges the same cost, so a count of real tensors on the
card and of fake ones agree.
"""

from __future__ import annotations

import torch

from ..scope import charge_kernel
from . import flash_attention as _flash
from . import rwkv6_scan as _wkv
from . import sa_fused as _fused
from . import sa_update as _update

__all__ = ["sa_update", "sa_fused_update", "sa_update_lanes",
           "sa_fused_update_lanes", "flash_attention", "wkv",
           "launch_counts", "reset_launch_counts", "add_launches"]

_MODES = ("auto", "plain")
_KERNELS = {"sa_update": _update, "sa_fused": _fused,
            "flash_attention": _flash, "rwkv6_wkv": _wkv}


def _route(mode: str, t) -> str:
    """"abstract" for a fake or meta tensor (a DTensor's local shard), else
    "plain" or "kernel" by ``mode`` and the device."""
    if mode not in _MODES:
        raise ValueError(f"mode={mode!r}; expected one of {_MODES}")
    from torch._subclasses.fake_tensor import is_fake
    local = getattr(t, "_local_tensor", t)  # a DTensor's shard
    if is_fake(local) or local.device.type == "meta":
        return "abstract"
    return "plain" if mode == "plain" or t.device.type == "cpu" else "kernel"


def _placements_of(placements, dims: dict[int, int | None]):
    """The placements of an operand whose dim ``dims[d]`` runs with the
    main operand's dim ``d``: the main operand's ``Shard(d)`` (in
    ``placements``) on each mesh dim where ``d`` is in ``dims`` (and maps
    somewhere), else ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard)
                 and dims.get(p.dim) is not None else Replicate()
                 for p in placements)


def _shards(main, operands):
    """``(mesh, placements of the main operand, local shards)``: each
    ``(tensor, dims)`` of ``operands`` placed as :func:`_placements` says
    (redistributed where it is not: a gather of a dim the kernel cannot
    split) and taken as its local shard; a plain tensor is taken whole.
    The mesh is None when no operand is a DTensor."""
    from torch.distributed.tensor import DTensor
    mains = [t for t, _ in operands if isinstance(t, DTensor)]
    if not mains:
        return None, None, [t for t, _ in operands]
    lead = main if isinstance(main, DTensor) else mains[0]
    mesh = lead.device_mesh
    # a mesh dim whose parts do not divide some operand's dim (a GQA's kv
    # heads) shards none of them
    from torch.distributed.tensor import Replicate, Shard
    keep = list(lead.placements)
    for i, p in enumerate(keep):
        if isinstance(p, Shard) and any(
                dims.get(p.dim) is not None
                and t.shape[dims[p.dim]] % mesh.size(i)
                for t, dims in operands if isinstance(t, DTensor)):
            keep[i] = Replicate()
    lead_pl = tuple(keep)
    out = []
    for t, dims in operands:
        if isinstance(t, DTensor):
            want = _placements_of(lead_pl, dims)
            if tuple(t.placements) != want:
                t = t.redistribute(mesh, want)
            t = t.to_local()
        out.append(t)
    return mesh, lead_pl, out


def _placed(mesh, placements, t, dims: dict[int, int | None]):
    """Local output ``t`` as a DTensor on ``mesh`` (its dim ``dims[d]``
    sharded as the main operand's dim ``d``); ``t`` itself without a
    mesh."""
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, _placements_of(placements, dims),
                              run_check=False)


def _ident(n: int) -> dict[int, int]:
    return {d: d for d in range(n)}


def _abstract_combine(name, x, buf, xi, coeffs, rows: int, lanes: bool):
    """The abstract call of a combine (elementwise: every dim of x may
    stay sharded): empty outputs like x, the kernel's cost charged."""
    nd = x.ndim
    lane = 1 if lanes else 0
    # buf has one more dim (P) after the lane dim
    bdims = {d: (d + 1 if d >= lane else d) for d in range(nd)}
    mesh, pl, (xl, bl, xil, cl) = _shards(x, [
        (x, _ident(nd)), (buf, bdims), (xi, _ident(nd)),
        (coeffs, {0: 0} if lanes else {})])
    L = xl.shape[0] if lanes else 1
    n = xl.numel() // L
    P = bl.shape[lane]
    mod = _update if rows == 1 else _fused
    flops, nbytes = mod.cost(n, P, xl.element_size(), lanes=L)
    charge_kernel(name, flops, nbytes)
    outs = tuple(_placed(mesh, pl, xl.new_empty(xl.shape), _ident(nd))
                 for _ in range(rows))
    return outs[0] if rows == 1 else outs


def _charge_flash(q, k, causal: bool) -> None:
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    charge_kernel("flash_attention",
                  *_flash.cost(B, H, K, S, T, hd, causal, q.element_size()))


def _charge_wkv(r, chunk: int) -> None:
    B, T, H, hd = r.shape
    charge_kernel("rwkv6_wkv",
                  *_wkv.cost(B, T, H, hd, chunk, r.element_size()))


def sa_update(x, buf, xi, coeffs, *, mode: str = "auto"):
    """coeffs [P+2] packed as (decay, noise, b_0..b_{P-1})."""
    route = _route(mode, x)
    if route == "abstract":
        return _abstract_combine("sa_update", x, buf, xi, coeffs, 1, False)
    if route == "plain":
        return _update.sa_update_plain(x, buf, xi, coeffs)
    out = _update.sa_update(x, buf, xi, coeffs)
    charge_kernel("sa_update", *_update.cost(x.numel(), buf.shape[0],
                                             x.element_size()))
    return out


def sa_fused_update(x, buf, xi, coeffs, *, mode: str = "auto"):
    """coeffs [2, P+2] (row 0 predictor, row 1 corrector) ->
    ``(x_pred, corr_base)``."""
    route = _route(mode, x)
    if route == "abstract":
        return _abstract_combine("sa_fused", x, buf, xi, coeffs, 2, False)
    if route == "plain":
        return _fused.sa_fused_update_plain(x, buf, xi, coeffs)
    out = _fused.sa_fused_update(x, buf, xi, coeffs)
    charge_kernel("sa_fused", *_fused.cost(x.numel(), buf.shape[0],
                                           x.element_size()))
    return out


def sa_update_lanes(x, buf, xi, coeffs, *, mode: str = "auto"):
    """Lane-batched ``sa_update``: x [L, *shape], buf [L, P, *shape], coeffs
    [L, P+2]; counted under ``sa_update``."""
    route = _route(mode, x)
    if route == "abstract":
        return _abstract_combine("sa_update", x, buf, xi, coeffs, 1, True)
    if route == "plain":
        return _update.sa_update_lanes_plain(x, buf, xi, coeffs)
    out = _update.sa_update_lanes(x, buf, xi, coeffs)
    L = x.shape[0]
    charge_kernel("sa_update", *_update.cost(
        x.numel() // L, buf.shape[1], x.element_size(), lanes=L))
    return out


def sa_fused_update_lanes(x, buf, xi, coeffs, *, mode: str = "auto"):
    """Lane-batched ``sa_fused_update``: coeffs [L, 2, P+2] ->
    ``(x_pred, corr_base)``, each [L, *shape]; counted under
    ``sa_fused``."""
    route = _route(mode, x)
    if route == "abstract":
        return _abstract_combine("sa_fused", x, buf, xi, coeffs, 2, True)
    if route == "plain":
        return _fused.sa_fused_update_lanes_plain(x, buf, xi, coeffs)
    out = _fused.sa_fused_update_lanes(x, buf, xi, coeffs)
    L = x.shape[0]
    charge_kernel("sa_fused", *_fused.cost(
        x.numel() // L, buf.shape[1], x.element_size(), lanes=L))
    return out


def flash_attention(q, k, v, *, causal: bool = True, mode: str = "auto"):
    route = _route(mode, q)
    if route == "abstract":
        # batch and heads split freely (a kv head's query heads stay with
        # it when both head counts split alike); S, T and hd do not
        dims = {0: 0, 1: 1}
        mesh, pl, (ql, kl, vl) = _shards(q, [(q, dims), (k, dims),
                                             (v, dims)])
        _charge_flash(ql, kl, causal)
        return _placed(mesh, pl, ql.new_empty(ql.shape), dims)
    if route == "plain":
        return _flash.flash_attention_plain(q, k, v, causal=causal)
    out = _flash.flash_attention(q, k, v, causal=causal)
    _charge_flash(q, k, causal)
    return out


def wkv(r, k, v, logw, u, S0, *, chunk: int = 64, mode: str = "auto"):
    """Chunked RWKV6 WKV -> ``(y, S_T)``, both float32; raises unless
    ``chunk`` divides T."""
    route = _route(mode, r)
    if route == "abstract":
        # [B, T, H, hd]: batch and heads split freely, time does not;
        # u [H, hd] and S0 / S_T [B, H, hd, hd] follow the heads
        dims, hdims, sdims = {0: 0, 2: 2}, {2: 0}, {0: 0, 2: 1}
        mesh, pl, (rl, kl, vl, wl, ul, sl) = _shards(r, [
            (r, dims), (k, dims), (v, dims), (logw, dims), (u, hdims),
            (S0, sdims)])
        B, T, H, hd = rl.shape
        if T % chunk:
            raise ValueError(f"T={T} must be divisible by chunk={chunk}")
        _charge_wkv(rl, chunk)
        y = rl.new_empty((B, T, H, hd), dtype=torch.float32)
        s = rl.new_empty((B, H, hd, hd), dtype=torch.float32)
        return _placed(mesh, pl, y, dims), _placed(mesh, pl, s, sdims)
    if route == "plain":
        return _wkv.rwkv6_wkv_plain(r, k, v, logw, u, S0, chunk=chunk)
    out = _wkv.rwkv6_wkv(r, k, v, logw, u, S0, chunk=chunk)
    _charge_wkv(r, chunk)
    return out


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the wrappers' counts: a
    CUDA graph replay launches its captured kernels without running the
    wrappers, so the replay adds the launches its capture recorded."""
    for name, n in counts.items():
        _KERNELS[name].launches += n
