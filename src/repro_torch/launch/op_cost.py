"""Per-device cost of a step, counted from the ops it runs: the port's
counterpart of the reference's ``launch/hlo_cost.py``.

The reference walks the post-optimisation HLO of a compiled step, one
SPMD partition: dots' FLOPs, transcendentals, bytes of every unfused
instruction, collective bytes at result size, with while-loop trip counts
folded in. The port has no compiled artifact to read. It counts the step
as it runs, eager, through a ``TorchDispatchMode`` that sees every ATen
op (:class:`count_ops` over real tensors; :class:`CountingFakeMode`, the
dry run's ``FakeTensorMode``, over fake ones), and reckons per device:

    flops            2 M N K for mm / addmm / bmm / baddbmm (and mv, dot),
                     which is what matmul, linear and einsum lower to
    transcendentals  output elements of exp / log / tanh / rsqrt / pow /
                     sigmoid / sqrt / sin / cos / expm1 / log1p (and the
                     fused softmax / logsumexp / gelu / silu ops)
    bytes            inputs plus outputs of every op but views and
                     metadata ops; an in-place write into a view (copy_,
                     index_copy_, index_put_, scatter_, slice assignment)
                     at the written region, the analog of the reference's
                     dynamic-update-slice rule: a ring-history row write
                     costs one row, not [P, N]
    coll_bytes       per kind (the reference's names: all-gather,
                     all-reduce, reduce-scatter, all-to-all), from the
                     ``_c10d_functional`` ops (and the c10d ops of
                     ``torch.distributed``'s own calls) at result size
    region_bytes     ``{"backbone", "solver"}``, summing to ``bytes``: an
                     op inside ``scope.named_scope("backbone")`` (the
                     ``Denoiser``'s network call), a matmul contracting
                     16 or more, or the attention or WKV kernel, is
                     backbone; the rest solver (the reference's
                     raw-instruction rule)
    kernels          each hand-written kernel's calls, FLOPs and bytes
                     from its own ``cost`` (``scope.charge_kernel``): a
                     launch is invisible to a dispatch mode, and a fake
                     tensor takes the kernel's abstract branch
                     (``kernels.ops``), never its plain version. Kernel
                     FLOPs and bytes are in ``flops`` and ``bytes`` too

Per device means per local shard. A DTensor op is seen twice by a fake
mode: at the DTensor level, at global shapes (and by DTensor's own
sharding propagation, again at global shapes), then as the local op on
the shard. :class:`CountingFakeMode` counts only the local ops, and
holds the count while DTensor derives an output's metadata. Stock
counters (``FlopCounterMode``, ``MemTracker``) report the global shapes.

What does not carry over from the reference:
- There is no fusion in eager mode, so ``bytes`` is the unfused traffic
  of every op, an upper bound on what a fused program moves (the
  reference's HLO charges a fusion at its operands and result).
- There are no trip counts: a Python loop runs, and is counted, once per
  iteration. A solve inside a CUDA graph shows no ops on replay, so the
  counter runs eager and never inside the compile cache's capture
  (``core/samplers/base.py``): the dry run's solve runs under
  ``samplers.eager()``.
- ``cpu_upcast_bytes`` (the reference's hoisted bf16 -> f32 weight
  copies of XLA's CPU backend) has no counterpart: nothing here compiles
  for the CPU.
- The port's pipeline rotation (``distributed.ppermute``) is an
  all-gather of every stage's tensor, so it counts as all-gather bytes,
  more than the reference's collective-permute of one tensor.

:class:`CountingFakeMode` also tracks the high-water mark of live local
storages (``peak_bytes``): every storage an op makes is live until the
last tensor on it is freed; storages made before the count are added by
:meth:`OpCost.track`.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import scope

__all__ = ["OpCost", "count_ops", "CountingFakeMode", "BACKBONE_CONTRACT"]

#: a matmul contracting at least this many elements is backbone compute
#: (the reference's ``backbone_contract``)
BACKBONE_CONTRACT = 16
#: op outputs listed by ``OpCost.big_shapes``
BIG_SHAPE = 2**28

_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "tanh", "rsqrt", "pow",
                   "sigmoid", "sqrt", "sin", "cos", "expm1", "log1p",
                   "_softmax", "_log_softmax", "logsumexp", "gelu", "silu",
                   "erf"}
#: the index of each matmul-type op's left operand (its last dim is the
#: contraction)
_MATMUL = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "mv": 0, "addmv": 1,
           "dot": 0}
#: ops that move no data: allocation, metadata, waits
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "size", "stride", "is_contiguous", "numel",
         "_local_scalar_dense", "lift_fresh", "detach", "alias", "set_",
         "wait_tensor", "device", "is_same_size", "_has_same_storage_numel",
         "resize_", "record_stream", "_record_function_enter_new",
         "_record_function_exit", "_record_function_enter"}
#: in-place writes of a region: (index of the written tensor, of the
#: source whose size is the region)
_REGION_WRITES = {"copy_": (0, 1), "index_copy_": (0, 3),
                  "index_put_": (0, 2), "_index_put_impl_": (0, 2),
                  "scatter_": (0, 3), "index_fill_": (0, None),
                  "masked_scatter_": (0, 2)}
#: writes of the whole (view) operand that read nothing of it
_FILLS = {"fill_", "zero_", "normal_", "uniform_", "bernoulli_",
          "random_", "exponential_"}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    # torch.distributed's own calls (c10d ops; results in their arguments)
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
}
#: c10d ops whose result is their first argument
_C10D_RESULT_IN_ARG0 = {"allgather_", "_allgather_base_", "allreduce_",
                        "reduce_scatter_", "_reduce_scatter_base_",
                        "alltoall_base_", "broadcast_"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class OpCost:
    """Per-device counts of one counted run (see the module docstring)."""
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    region_bytes: dict = dataclasses.field(
        default_factory=lambda: {"backbone": 0.0, "solver": 0.0})
    kernels: dict = dataclasses.field(default_factory=dict)
    #: high-water mark and current sum of live storages (fake runs)
    peak_bytes: int = 0
    live_bytes: int = 0
    ops: int = 0
    #: collective bytes per (kind, process group name)
    coll_by_group: dict = dataclasses.field(default_factory=dict)
    #: when a dict: {(dtype, shape): (bytes, count)} of op outputs of
    #: ``BIG_SHAPE`` bytes or more (``dryrun --dump-shapes``)
    big_shapes: dict | None = None

    def __post_init__(self):
        self._live: dict[int, tuple] = {}

    @property
    def collective_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    # ---- memory ----------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live from now on."""
        for t in _tensors(tree):
            self._track_one(getattr(t, "_local_tensor", t))

    def _track_one(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n, cost=weakref.ref(self)):
            c = cost()
            if c is not None and c._live.pop(key, None) is not None:
                c.live_bytes -= n
        self._live[key] = (weakref.ref(st, gone), n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # ---- charges -------------------------------------------------------
    def _charge_bytes(self, b: float, backbone: bool) -> None:
        self.bytes += b
        self.region_bytes["backbone" if backbone else "solver"] += b

    def charge_kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self._charge_bytes(nbytes, "backbone" in scope.current_scopes()
                           or name in ("flash_attention", "rwkv6_wkv"))

    def charge(self, func, args, kwargs, out) -> None:
        """One ATen op's flops, transcendentals, bytes and collectives."""
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        for t in outs:
            self._track_one(t)
        if name in _FREE or getattr(func, "is_view", False):
            return
        self.ops += 1
        ins = _tensors((args, kwargs))
        backbone = "backbone" in scope.current_scopes()
        if name in _MATMUL:
            k = args[_MATMUL[name]].shape[-1]
            self.flops += 2.0 * outs[0].numel() * k
            backbone = backbone or k >= BACKBONE_CONTRACT
        elif name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        if self.big_shapes is not None:
            for t in outs:
                if _nbytes(t) >= BIG_SHAPE:
                    key = (str(t.dtype).replace("torch.", ""),
                           tuple(t.shape))
                    count = self.big_shapes.get(key, (0, 0))[1]
                    self.big_shapes[key] = (_nbytes(t), count + 1)
        if name in _COLLECTIVES:
            res = _tensors(args[0]) if name in _C10D_RESULT_IN_ARG0 else outs
            kind = _COLLECTIVES[name]
            b = sum(_nbytes(t) for t in res)
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + b
            group = next((a for a in reversed(args) if isinstance(a, str)),
                         None)
            self.coll_by_group[(kind, group)] = \
                self.coll_by_group.get((kind, group), 0.0) + b
        if name in _REGION_WRITES:
            dst_i, src_i = _REGION_WRITES[name]
            dst = args[dst_i]
            region = dst.numel() if src_i is None or len(args) <= src_i \
                else args[src_i].numel()
            read = sum(_nbytes(t) for t in ins if t is not dst)
            self._charge_bytes(read + region * dst.element_size(), backbone)
            return
        if name in _FILLS:
            self._charge_bytes(_nbytes(args[0]), backbone)
            return
        # out of place: inputs read, outputs written; in place: the
        # mutated operand read and written (it is an input and the output)
        self._charge_bytes(sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs), backbone)


class count_ops(TorchDispatchMode):
    """Count the ops run on real (or fake) plain tensors into ``cost``
    (an :class:`OpCost`), and the kernels' charges while active. A
    DTensor's local ops are not seen by a mode entered outside it: count
    DTensor runs with :class:`CountingFakeMode`."""

    def __init__(self, cost: OpCost | None = None):
        super().__init__()
        self.cost = OpCost() if cost is None else cost

    def __enter__(self):
        scope.active_counters.append(self.cost)
        return super().__enter__()

    def __exit__(self, *exc):
        scope.active_counters.remove(self.cost)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.charge(func, args, kwargs, out)
        return out


class CountingFakeMode(FakeTensorMode):
    """A ``FakeTensorMode`` that counts the ops on its fake tensors (a
    DTensor's local shards included) into ``cost`` while counting is on
    (:meth:`counting`). An op with a DTensor operand is left to DTensor,
    which runs the local op on the shard through this mode; while
    DTensor's sharding propagation derives an output's global metadata
    (on fake tensors of this mode) nothing is counted."""

    def __init__(self, cost: OpCost | None = None, **kw):
        kw.setdefault("allow_non_fake_inputs", True)
        super().__init__(**kw)
        self.cost = OpCost() if cost is None else cost
        self._on = 0
        self._held = 0
        self._depth = 0

    def counting(self):
        mode = self

        class _Counting:
            def __enter__(self_):
                mode._on += 1
                scope.active_counters.append(mode.cost)
                self_.restore = _plan_outside_fake_mode(mode)
                return mode.cost

            def __exit__(self_, *exc):
                self_.restore()
                scope.active_counters.remove(mode.cost)
                mode._on -= 1
                return False
        return _Counting()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # an op the fake mode decomposes reaches this mode again, op by op,
        # inside its own call: only the outermost op is the device's
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if self._on and not self._held and not self._depth \
                and out is not NotImplemented:
            from torch.distributed.tensor import DTensor
            if not any(isinstance(t, DTensor)
                       for t in _tensors((args, kwargs))):
                self.cost.charge(func, args, kwargs or {}, out)
        return out


def _plan_outside_fake_mode(mode: CountingFakeMode):
    """Run DTensor's planning (its sharding propagation, which derives an
    output's global metadata on fake tensors of the global shapes, and
    its redistribution planner) with ``mode`` off the mode stack and its
    count held: DTensor's planner builds small index tensors it reads on
    the host, which a fake mode cannot give, and the global-shape ops are
    not the device's work (the shard's own op follows and is counted).
    Returns the function that undoes it."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator

    def outside(inner):
        def run(*a, **k):
            mode._held += 1
            try:
                with unset_fake_temporarily():
                    return inner(*a, **k)
            finally:
                mode._held -= 1
        return run

    # (owner, attribute) of each planning entry point this PyTorch has
    sites = [(DTensor._op_dispatcher,
              "_propagate_op_sharding_dispatch_slow_path"),
             (prop, "propagate"), (prop, "propagate_op_sharding")]
    saved = []
    for owner, name in sites:
        if hasattr(owner, name):
            saved.append((owner, name, owner.__dict__.get(name)))
            setattr(owner, name, outside(getattr(owner, name)))
    # the redistribution planner: a strided shard makes DTensor search for
    # the least-cost path over every state of the mesh, minutes for one
    # einsum's candidate strategies on a 3-D mesh. Ranking the candidates
    # takes the greedy plan's cost instead; a redistribution that runs
    # still takes DTensor's own plan.
    plan = getattr(_redistribute, "_gen_transform_infos", None)
    if plan is not None:
        costing = [0]

        def planned(src, dst, *a, **k):
            if costing[0] and hasattr(_redistribute,
                                      "get_redistribute_planner"):
                try:
                    return _redistribute.get_redistribute_planner(
                        src.device_mesh, src.tensor_meta
                    ).generate_greedy_transform_infos(src, dst)
                except Exception:  # noqa: BLE001 - DTensor's own plan then
                    pass
            return plan(src, dst, *a, **k)
        saved.append((_redistribute, "_gen_transform_infos", plan))
        _redistribute._gen_transform_infos = outside(planned)
        import importlib
        for mod_name in ("_collective_utils", "_redistribute", "_utils",
                         "_ops.utils", "_ops._tensor_ops", "_ops._math_ops",
                         "_ops.single_dim_strategy", "_sharding_prop"):
            try:
                mod = importlib.import_module(
                    f"torch.distributed.tensor.{mod_name}")
            except ImportError:
                continue
            cost_fn = mod.__dict__.get("redistribute_cost")
            if cost_fn is None:
                continue

            def ranked(*a, _fn=cost_fn, **k):
                costing[0] += 1
                try:
                    return _fn(*a, **k)
                finally:
                    costing[0] -= 1
            saved.append((mod, "redistribute_cost", cost_fn))
            mod.redistribute_cost = ranked
    # a shard's size and offsets come from host index tensors that
    # DTensor builds, splits and reads (``tolist``, ``int``): on the host
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor import placement_types as pt
    for owner, name in ((getattr(pt, "_StridedShard", None),
                         "local_shard_size_and_offset"),
                        (_utils, "_compute_local_shape_and_global_offset")):
        fn = None if owner is None else owner.__dict__.get(name)
        if callable(fn):
            def on_host(*a, _fn=fn, **k):
                with unset_fake_temporarily():
                    return _fn(*a, **k)
            saved.append((owner, name, fn))
            setattr(owner, name, on_host)

    def restore():
        for owner, name, old in reversed(saved):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
    return restore
