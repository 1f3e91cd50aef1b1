"""Census of the ops a run dispatches (counterpart of
``repro/launch/hlo_census.py``).

The reference parses a compiled HLO module and weights each instruction by
the trip counts of its enclosing while loops. The port runs eagerly, so it
counts the stream of ops the program dispatches instead: :class:`Census` is
a ``TorchDispatchMode`` that sees every aten and ``c10d`` op of a run (the
backward's too, the autograd engine carries the mode to its threads) and
records, per rank, in the reference's keys where they exist:

* ``flops`` — ``torch.utils.flop_counter``'s registered formula of each op
  (2·M·N·K for ``mm``, ``addmm``, ``bmm``, ``baddbmm``), the fused SDPA
  ops' 4·B·H·Sq·Sk·D forward and 8·B·H·Sq·Sk·D backward (``_sdpa_flops``:
  GQA's query heads counted, causal masks not halved), plus each
  hand-written kernel's.
* ``hbm_bytes`` — operand plus result bytes of every op that does work
  (elements a stride-0 dim repeats are read once). Views, aliases,
  ``detach`` and allocations without a write count zero; copies between
  the host and the device (a constant's first upload) are left out. Eager PyTorch
  fuses nothing, so this is the traffic of the program as it runs.
* ``n_ops`` — the ops that launch work: the counterpart of the reference's
  "real top-level instructions".
* ``collectives`` — each ``c10d`` op by the reference's kind
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``broadcast``): its count, result bytes, group size and ring wire bytes
  (:func:`_wire_factor`, the reference's).
* ``kernels`` — the launches of the four hand-written kernels, each with
  the operations and bytes of its bound (``PERF.md`` §6): a wrapper of
  :mod:`repro_torch.kernels.ops` records one launch through
  :func:`repro_torch.census.kernel_launch` and its own ops (the plain version on the CPU, the
  orders and outputs it builds on the card) are not counted, so a CPU, a
  ``meta`` and a card census of one program agree.
* ``peak_bytes`` — the most bytes live at once: every tensor storage an op
  creates is counted until the last tensor that reads it is freed (a
  weak-reference finaliser on each tensor), the tensors live at the start
  through :meth:`Census.track`.

``while_trip_counts`` has no counterpart: eager code unrolls its loops, and
each trip dispatches its ops again. A CUDA graph's replay dispatches
nothing, so a census of ``generate`` on the card runs the eager route
(``ops.eager_route()``). On ``meta`` the model takes the card's routes:
attention the cuDNN SDPA op (``models/attention.py``), the engine the
kernel route, each kernel wrapper a shape-only launch.

:func:`census_stream_program` censuses the streaming engine's
``scan_panels`` on either route; ``tools/torch_census_check.py`` gates the
chunk route against the per-panel body.
"""

from __future__ import annotations

import copy
import time
import weakref
from collections import Counter, defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..census import ACTIVE, nbytes

__all__ = ["Census", "census_stream_program", "nbytes"]

aten = torch.ops.aten

# ops that launch no work: allocations without a write, metadata, reads of a
# value back to the host
_NO_WORK = {
    aten.empty.memory_format, aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.empty_like.default, aten.detach.default,
    aten.alias.default, aten._local_scalar_dense.default,
    aten.set_.source_Storage_storage_offset, aten.resize_.default,
}

# ops whose result aliases their input's storage without the schema saying
# so (on ``meta`` it comes back with storage of its own)
_ALIAS = {aten._unsafe_view.default, aten._reshape_alias.default}

# c10d op name -> the reference's collective kind
_COLLECTIVE = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather", "allgather_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast",
}


def _wire_factor(op: str, g: int) -> float:
    """Ring-algorithm wire bytes per device, as a multiple of the result
    bytes (the reference's, copied)."""
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "all-gather":
        return (g - 1) / g
    if op == "reduce-scatter":
        return float(g - 1)
    if op == "all-to-all":
        return (g - 1) / g
    if op == "collective-permute":
        return 1.0
    return 1.0


def _tensors(tree) -> list:
    # the tensors of nested lists, tuples and dicts (no recursive closure: a
    # reference cycle would keep them alive until the next collection)
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, torch.nn.Module):
            stack.extend(reversed(list(x.parameters())))
    return out


def _sdpa_flops(func, args) -> float:
    """A fused attention op's products on (B, H, S, D) operands, GQA's KV
    heads read by every query head of their group: 2·B·H·Sq·Sk·(D + Dv)
    forward (QKᵀ and PV), twice that backward (dQ, dK, dV, dP); a causal
    mask is not halved, as ``torch.utils.flop_counter`` counts it (whose own
    formula refuses GQA in some releases)."""
    q, k, v = args[1:4] if "backward" in func.__name__ else args[:3]
    B, H, Sq, D = q.shape
    fwd = 2.0 * B * H * Sq * k.shape[-2] * (D + v.shape[-1])
    return 2.0 * fwd if "backward" in func.__name__ else fwd


def _transfer(func, args, out) -> bool:
    # a copy between the host and the device (a constant's first upload, a
    # read back): not device work, and made once where the device differs
    if func not in (aten._to_copy.default, aten.copy_.default):
        return False
    devs = {t.device.type for t in _tensors(args) + _tensors(out)}
    return len(devs) > 1


def _group_size(args) -> int:
    # the process group is a boxed script object among a c10d op's arguments
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return int(dist.ProcessGroup.unbox(a).size())
            except RuntimeError:  # another boxed argument (a ReduceOp)
                continue
    return 1


class Census(TorchDispatchMode):
    """Count one run's ops (see the module docstring): ``with Census() as
    c: ...``, then ``c.result()``. ``track_frees=False`` never subtracts a
    freed storage, so ``peak_bytes`` is every allocation's sum (a control
    that must miss the card's peak)."""

    def __init__(self, *, track_frees: bool = True):
        super().__init__()
        self.track_frees = track_frees
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.n_ops = 0
        self.collectives: dict = defaultdict(
            lambda: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0, "group_size": 0})
        self.kernels: dict = defaultdict(lambda: {"launches": 0, "flops": 0.0, "bytes": 0.0})
        self.by_op: Counter = Counter()  # ops that do work, by name
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._paused = 0
        self._t0 = 0.0
        self.wall_s = 0.0

    # -- memory ---------------------------------------------------------
    # a storage is live while a tensor that reads it is: each tensor an op
    # returns holds its storage (keyed by the storage's address in memory)
    # until the tensor is freed, a weak-reference finaliser on it
    def _release(self, key: int) -> None:
        rec = self._storages[key]
        rec[1] -= 1
        if rec[1] == 0:
            del self._storages[key]
            if self.track_frees:
                self.live -= rec[0]

    def _hold(self, t: torch.Tensor, key: int, n: int) -> None:
        rec = self._storages.get(key)
        if rec is None:
            rec = self._storages[key] = [n, 0]
            self.live += n
            self.peak = max(self.peak, self.live)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _alloc(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        self._hold(t, st._cdata, st.nbytes())

    def track(self, *trees) -> None:
        """Count the tensors of ``trees`` (nested lists, tuples, dicts and
        modules' parameters) as live: the state a step starts from."""
        for t in _tensors(trees):
            self._alloc(t)

    # -- ops ------------------------------------------------------------
    def __enter__(self):
        ACTIVE.append(self)
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        self.wall_s += time.perf_counter() - self._t0
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _ALIAS:  # the result reads its base's storage (its own on ``meta``)
            if not self._paused:
                st = args[0].untyped_storage()
                self._hold(out, st._cdata, st.nbytes())
            return out
        if self._paused or func is aten.lift_fresh.default or _transfer(func, args, out):
            return out  # a host constant, or its upload: made once, wherever the device
        for t in _tensors(out):
            self._alloc(t)
        if func in _NO_WORK or getattr(func, "is_view", False):
            return out
        name = func.namespace
        if name == "c10d":
            self._collective(func, args)
        elif name not in ("aten", "prims"):
            return out  # python-level and profiler ops do no work
        self.n_ops += 1
        self.by_op[func.__name__] += 1
        ins = _tensors(args) + _tensors(kwargs)
        self.hbm_bytes += sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in _tensors(out))
        if func.__name__.startswith("_scaled_dot_product_"):
            self.flops += _sdpa_flops(func, args)
        else:
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                # an output dtype (``bmm.dtype``'s fp32 out of bf16 operands)
                # is no operand: the formulas read shapes
                ops_ = [a for a in args if not isinstance(a, torch.dtype)]
                kw = {k: v for k, v in kwargs.items() if not isinstance(v, torch.dtype)}
                self.flops += float(formula(*ops_, **kw, out_val=out))
        return out

    def _collective(self, func, args) -> None:
        kind = _COLLECTIVE.get(func._opname)
        if kind is None:
            return
        ts = _tensors(args[0])  # the result: in place, or the output argument
        rb = float(sum(nbytes(t) for t in ts))
        g = _group_size(args)
        rec = self.collectives[kind]
        rec["count"] += 1
        rec["result_bytes"] += rb
        rec["wire_bytes"] += rb * _wire_factor(kind, max(g, 1))
        rec["group_size"] = max(rec["group_size"], g)

    def kernel(self, name: str, flops: float, nbytes_: float, outputs=()) -> None:
        """One launch of a hand-written kernel: its bound's operations and
        bytes, its outputs counted live."""
        rec = self.kernels[name]
        rec["launches"] += 1
        rec["flops"] += float(flops)
        rec["bytes"] += float(nbytes_)
        self.flops += float(flops)
        self.hbm_bytes += float(nbytes_)
        self.n_ops += 1
        self.by_op[f"kernel:{name}"] += 1
        for t in _tensors(outputs):
            self._alloc(t)

    def result(self, by_op: bool = False) -> dict:
        """The census (see the module docstring); ``by_op`` adds the count of
        each op that did work, by name."""
        extra = {"by_op": dict(self.by_op)} if by_op else {}
        return {**extra,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "n_ops": self.n_ops,
            "collectives": {k: dict(v) for k, v in self.collectives.items()},
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "peak_bytes": self.peak,
            "wall_s": self.wall_s,
        }


# ---------------------------------------------------------------------------
# streaming-program census (scan_panels)
# ---------------------------------------------------------------------------


def _stream_census(state, A, panel: int, num_panels: int, fused: bool) -> dict:
    from ..stream import engine

    st = copy.deepcopy(state)
    with Census() as c:
        engine.scan_panels(st, A, num_panels, panel, fused=fused)
    return c.result()


def census_stream_program(state, A, panel: int, *, fused: bool = True) -> dict:
    """Census of the engine's ``scan_panels`` over the whole panels of ``A``
    (at least 2) from a copy of ``state``: ``fused=True`` is the chunk route, ``fused=False`` the
    per-panel body. Returns the census plus

    * ``num_panels``, ``bytes_per_panel`` (whole-program bytes / panels,
      the chunk's one-off work included) and ``n_ops_per_panel``;
    * ``scan_body_bytes_per_panel`` and ``scan_body_n_ops`` — one panel in
      steady state, the counterpart of the reference's census of one trip
      of the scan's while body: the difference between the censuses of
      ``N`` and ``2N`` panels (``N = num_panels // 2``), divided by ``N``,
      so work done once per stream drops out.

    Off the card, run it on the CPU with the kernel route forced
    (``ops._FORCE_KERNEL_ROUTE``): the kernels' plain versions are not
    counted, so the numbers are the card's program's. (A stream on ``meta``
    runs too, but for adaptive rows, whose backfill reads back whether a
    row was admitted.)"""
    n = A.shape[1] // panel
    if n < 2:
        raise ValueError(f"census_stream_program needs at least 2 panels, got {n}")
    half = n // 2
    whole = _stream_census(state, A, panel, n, fused)
    c1 = whole if 2 * half == n else _stream_census(state, A, panel, 2 * half, fused)
    c0 = _stream_census(state, A, panel, half, fused)
    out = dict(whole)
    out.update(
        num_panels=n, fused=fused,
        bytes_per_panel=whole["hbm_bytes"] / n,
        n_ops_per_panel=whole["n_ops"] / n,
        scan_body_bytes_per_panel=(c1["hbm_bytes"] - c0["hbm_bytes"]) / half,
        scan_body_n_ops=(c1["n_ops"] - c0["n_ops"]) / half,
    )
    return out
