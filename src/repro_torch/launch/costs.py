"""Roofline accounting of the port: counted work over the H100's terms.

Port of ``repro/launch/costs.py``. Three terms a rank, as the reference's:

    compute    = FLOPs / (ranks · peak FLOP/s of the cell's type)
    memory     = bytes / (ranks · HBM bytes/s)
    collective = Σ_calls bytes · factor / (the slowest link the call's group crosses)

with the card's data-sheet values (:data:`H100`). The work is counted on
a traced step (:class:`WorkCounter`): one rank's real step, run once on
the ``meta`` device (``launch/lowering.py``), or on a real device where a
count is held against a run. FLOPs are ``FlopCounterMode``'s: the products
(``mm``, ``bmm``, ``addmm``, the einsums that lower to them, attention and
convolutions), elementwise work uncounted. Bytes are every ATen op's inputs
read and outputs written, once an op, views and allocations free: the
eager traffic, with no fusion. The peak is the largest sum of live storages
(added on allocation, taken off when a storage's weak reference dies).
Where a hand kernel's entry point (``kernels/ops.py``) runs its plain
version, the count takes the kernel's own work, by the formulas below, in
place of the plain version's ops.

There is no scan correction (the reference's ``flop_correction`` and
``bytes_correction``): the port's loops are Python loops, and a traced
step runs every trip. The closed forms of one attention, SSD, mLSTM and
sLSTM instance (:func:`attn_flops`, ...) stay as the tests' yardstick for
the counted FLOPs. The reference's HLO parser has no counterpart: the
collectives are those the port issues, recorded by the counting ranks
(``launch/dry_ranks.py``), with the parser's op factors (all-reduce ×2,
the others ×1). The port writes its sums as an all-gather plus adds in rank
order, so a sum over P ranks is priced as an all-gather of P parts.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, ShapeSpec


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Hardware:
    """A card's peak rates and its links. Rank ``r`` sits on node
    ``r // node_size``; a group within one node talks over NVLink, a group
    across nodes at the network's rate a card."""

    name: str
    bf16_flops: float  # dense, on the tensor cores
    fp32_flops: float  # outside the tensor cores
    fp64_flops: float  # outside the tensor cores
    hbm_bytes_per_s: float
    nvlink_bytes_per_s: float  # a card, each way
    node_size: int
    internode_bytes_per_s: float  # a card
    num_sms: int
    sfu_per_sm_per_clk: int

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        return {"bfloat16": self.bf16_flops, "float32": self.fp32_flops,
                "float64": self.fp64_flops}[dtype]

    def link_bytes_per_s(self, ranks) -> float:
        """The slowest link a group of global ``ranks`` crosses."""
        nodes = {int(r) // self.node_size for r in ranks}
        return self.nvlink_bytes_per_s if len(nodes) <= 1 else self.internode_bytes_per_s


#: NVIDIA H100 SXM 80GB, data-sheet values: 989 TFLOP/s dense bfloat16, 67
#: TFLOP/s float32 and 34 TFLOP/s float64 outside the tensor cores, 3.35 TB/s
#: HBM3, 900 GB/s NVLink (450 GB/s each way) among the 8 cards of a node,
#: 400 Gb/s NDR InfiniBand (50 GB/s) a card between nodes; 132 SMs with 16
#: special-function results an SM a clock.
H100 = Hardware(name="NVIDIA H100 SXM 80GB (data sheet)", bf16_flops=989e12,
                fp32_flops=67e12, fp64_flops=34e12, hbm_bytes_per_s=3.35e12,
                nvlink_bytes_per_s=450e9, node_size=8, internode_bytes_per_s=50e9,
                num_sms=132, sfu_per_sm_per_clk=16)


# ---------------------------------------------------------------------------
# closed forms (the tests' yardstick) and MODEL_FLOPS
# ---------------------------------------------------------------------------


def _mult(mode: str, remat: bool) -> float:
    """Forward 1; +2 backward; +1 the rematerialised forward."""
    if mode == "train":
        return 4.0 if remat else 3.0
    return 1.0


def attn_flops(b, s, t, heads, hd, mult: float = 1.0) -> float:
    """Matmul FLOPs of one attention instance: QKᵀ and PV over every
    ``s × t`` block (the blockwise scan computes masked blocks too)."""
    return 4.0 * b * heads * s * t * hd * mult


def ssd_flops(cfg: ModelConfig, b, s, mult: float = 1.0) -> float:
    """Matmul FLOPs of one SSD (Mamba2) instance over its chunks."""
    di = cfg.ssm_expand * cfg.d_model
    h = di // cfg.ssm_head_dim
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    q = min(cfg.ssm_chunk, s)
    return 2.0 * b * s * (q * n + q * h * p + 2.0 * h * n * p + q * h) * mult


def mlstm_flops(cfg: ModelConfig, b, s, mult: float = 1.0, chunk: int = 256) -> float:
    """Matmul FLOPs of one mLSTM cell over its chunks."""
    di = 2 * cfg.d_model
    h = cfg.n_heads
    p = di // h
    q = min(chunk, s)
    return 2.0 * b * s * (3.0 * q * h * p + 3.0 * h * p * p) * mult


def slstm_flops(cfg: ModelConfig, b, s, mult: float = 1.0) -> float:
    """Matmul FLOPs of one sLSTM step loop: four recurrent products a step."""
    dh = cfg.d_model // cfg.n_heads
    return 8.0 * b * s * cfg.d_model * dh * mult


def model_flops(cfg: ModelConfig, sp: ShapeSpec) -> float:
    """The useful work: 6·N·D for a train step, 2·N·D for a forward, N the
    active parameters."""
    n_active = cfg.active_param_count()
    if sp.kind == "train":
        return 6.0 * n_active * sp.global_batch * sp.seq_len
    if sp.kind == "prefill":
        return 2.0 * n_active * sp.global_batch * sp.seq_len
    return 2.0 * n_active * sp.global_batch  # decode: one token / sequence


# ---------------------------------------------------------------------------
# the hand kernels' own work
# ---------------------------------------------------------------------------


def merge_gain_flops(g: int, c: int, u: int) -> float:
    """The merge-gain scoring arithmetic of ``G`` groups: ``G·C²·(14·U+10)``."""
    return float(g) * c * c * (14.0 * u + 10.0)


def merge_gain_bytes(g: int, c: int, u: int) -> float:
    """Its operands read once and ``rel``/``red`` written once, float32/int32:
    ``m`` [G,C,U], ``n, s, t, cidx`` [G,C], ``n_u`` [G,U], ``w`` and the two
    outputs [G,C,C]."""
    return float(g) * (c * u + 3 * c * c + 4 * c + u) * 4


def pair_cost_bytes(e: int) -> float:
    """``cnt`` and ``π`` read, the cost written: 12 bytes a pair."""
    return 12.0 * e


def segment_sum_bytes(n_seg: int, nnz: int, n_long: int = 0) -> float:
    """``indptr`` (int64), the float64 values, the float64 sums and the long
    rows' list."""
    return 8.0 * (n_seg + 1) + 8.0 * nnz + 8.0 * n_seg + 8.0 * n_long


def ordered_sum_bytes(rows: int, cols: int) -> float:
    """A float64 ``[rows, cols]`` read and ``rows`` sums written."""
    return 8.0 * rows * cols + 8.0 * rows


def kernel_work(name: str, args) -> tuple[float, float]:
    """``(FLOPs, bytes)`` of one call of hand kernel ``name`` on ``args``,
    as ``kernels/ops.py`` passes them. The merge gain's FLOPs are its scoring
    arithmetic; the others' are float adds (the sums) or elementwise (the
    pair cost, uncounted as every elementwise op is)."""
    if name == "merge_gain":
        g, c, u = args[0].shape
        return merge_gain_flops(g, c, u), merge_gain_bytes(g, c, u)
    if name == "pair_cost":
        return 0.0, pair_cost_bytes(int(args[0].numel()))
    if name == "segment_sum":
        indptr, vals, long = args
        n_long = 0 if long is None else int(long.numel())
        return float(vals.numel()), segment_sum_bytes(int(indptr.numel()) - 1,
                                                      int(vals.numel()), n_long)
    if name == "ordered_sum":
        rows, cols = args[0].shape
        return float(rows * cols), ordered_sum_bytes(rows, cols)
    raise KeyError(f"no analytic cost for kernel {name!r}")


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

#: the reference parser's ring factors: all-reduce 2(n-1)/n ≈ 2, the others 1
OP_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(calls) -> dict[str, float]:
    """A rank's collective traffic by op kind (factors applied), the
    reference's keys and ``total``; ``calls`` are
    :class:`~repro_torch.launch.dry_ranks.Collective` records (a barrier
    moves nothing)."""
    out = {k: 0.0 for k in OP_FACTOR}
    out["total"] = 0.0
    for c in calls:
        if c.op in OP_FACTOR:
            b = c.bytes * OP_FACTOR[c.op]
            out[c.op] += b
            out["total"] += b
    return out


def collective_seconds(calls, hardware: Hardware = H100) -> float:
    """Each call's bytes (factor applied) over the slowest link its group
    crosses, summed: the collective term of one rank."""
    return sum(c.bytes * OP_FACTOR[c.op] / hardware.link_bytes_per_s(c.ranks)
               for c in calls if c.op in OP_FACTOR)


# ---------------------------------------------------------------------------
# roofline assembly
# ---------------------------------------------------------------------------


def roofline(*, hlo_flops_per_dev: float, hlo_bytes_per_dev: float,
             coll_bytes_per_dev: float, cfg: ModelConfig, sp: ShapeSpec, n_chips: int,
             remat: bool = True, hardware: Hardware = H100,
             t_collective: float | None = None) -> dict[str, Any]:
    """The three terms, the bottleneck and the useful-work ratios of one
    cell from a rank's counted FLOPs, bytes and collective bytes (the
    reference's keyword names). ``t_collective``: the collective term
    priced link by link (:func:`collective_seconds`); without it the
    bytes go over the slowest link of ``n_chips`` ranks. ``remat`` is
    taken for the reference's signature: the count already holds the
    rematerialised forward."""
    del remat
    flops_total = hlo_flops_per_dev * n_chips
    bytes_total = hlo_bytes_per_dev * n_chips
    peak = hardware.peak_flops(cfg.dtype)
    t_compute = flops_total / (n_chips * peak)
    t_memory = bytes_total / (n_chips * hardware.hbm_bytes_per_s)
    if t_collective is None:
        t_collective = coll_bytes_per_dev / hardware.link_bytes_per_s(range(n_chips))
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_collective}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, sp)
    t_model = mf / (n_chips * peak)
    step_time = max(terms.values())
    return {
        **{f"t_{k}": v for k, v in terms.items()},
        "bottleneck": bottleneck,
        "model_flops": mf,
        "hlo_flops_total": flops_total,
        "useful_ratio": mf / max(flops_total, 1.0),
        "roofline_fraction": t_model / max(step_time, 1e-12),
        "step_time_bound_s": step_time,
    }


# ---------------------------------------------------------------------------
# the count of a traced step
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: ops that allocate or alias and move no bytes
_FREE = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
         _aten.new_empty_strided, _aten.detach, _aten.alias, _aten._unsafe_view}
#: tensors made from host data: a 0-d tensor from a Python scalar (``x[i] =
#: 1``; the CPU makes it outside the dispatcher, a card and ``meta`` through
#: it) and a tensor from Python or numpy data entering the dispatcher
#: (``torch.tensor``, ``from_numpy``): neither bytes nor a storage of the
#: count on any device
_HOST_MADE = {_aten.scalar_tensor, _aten.lift_fresh}
#: ops whose output shape depends on the values (on ``meta`` the shape is
#: the all-nonzero upper bound)
_DATA_DEPENDENT = {_aten.nonzero, _aten.masked_select, _aten.unique_consecutive,
                   _aten._unique2, _aten.unique_dim}
#: ops that return a tensor on their input's storage without a view schema
_ALIASING = {_aten._unsafe_view, _aten.alias, _aten.detach}
_COPIES = {_aten._to_copy, _aten.copy_, _aten.copy}
_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
             torch.memory_format)


def _flat(args, kwargs) -> list:
    """The tensors among an op's arguments (top level and in lists)."""
    out = []
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _outputs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for x in out if isinstance(x, torch.Tensor)]
    return []


def _nbytes(x: torch.Tensor) -> int:
    return int(x.numel()) * x.element_size()


def _data_dependent(func, args) -> bool:
    if func.overloadpacket in _DATA_DEPENDENT:
        return True
    if func.overloadpacket in (_aten.index, _aten.index_put, _aten.index_put_):
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (args[1] or ()))
    return False


def _crosses(func, args, out) -> bool:
    """A copy between devices (a host tensor made by the Python code and
    moved to the step's device): ``_to_copy``'s input and output, or
    ``copy_``'s source and destination, on two devices."""
    src = args[1] if func.overloadpacket is not _aten._to_copy else args[0]
    dst = _outputs(out)
    return isinstance(src, torch.Tensor) and bool(dst) and src.device != dst[0].device


def _key(x):
    """A hashable stand-in for one argument of a ``meta`` op, or raise
    ``TypeError`` (the call is not memoised)."""
    if isinstance(x, torch.Tensor):
        return (x.size(), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(map(_key, x))
    if isinstance(x, _HASHABLE):
        return (type(x), x)
    raise TypeError(type(x))


def _pure(func) -> bool:
    """A functional op: no view, no in-place or ``out=`` write, no aliased
    return (its outputs are fresh storages whatever the inputs hold)."""
    if func.is_view or func.overloadpacket in _FREE or func.overloadpacket in _DATA_DEPENDENT:
        return False
    schema = func._schema
    return not any(a.alias_info is not None for a in schema.arguments) and \
        not any(r.alias_info is not None for r in schema.returns)


class _Counting(TorchDispatchMode):
    """Counts every ATen op into a :class:`WorkCounter`: its FLOPs by
    ``FlopCounterMode``'s formulas (``torch.utils.flop_counter.flop_registry``),
    its bytes, the storages it makes. On ``meta`` a functional op seen
    before with the same argument shapes, strides and dtypes is not run
    again: its outputs are made with ``empty_strided`` from the first call's
    shapes and strides, and its counts repeated."""

    def __init__(self, counter: "WorkCounter"):
        super().__init__()
        self.counter = counter
        self.memo: dict = {}
        self.pure: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.counter
        if c.paused or func.overloadpacket in _HOST_MADE:
            return func(*args, **kwargs)
        if _data_dependent(func, args):
            c.data_dependent += 1
        key = None
        pure = self.pure.get(func)
        if pure is None:
            pure = self.pure[func] = _pure(func)
        if c.device_type == "meta" and (func.is_view or func.overloadpacket in _ALIASING) \
                and isinstance(args[0], torch.Tensor) and args[0].device.type == "meta":
            return self._view(func, args, kwargs)
        if pure and c.device_type == "meta":
            try:
                key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
            except TypeError:
                key = None
            hit = self.memo.get(key) if key is not None else None
            if hit is not None:
                kind, metas, flops, nbytes = hit
                out = [None if m is None else torch.empty_strided(
                    m[0], m[1], dtype=m[2], device="meta") for m in metas]
                out = out[0] if kind is None else kind(out)
                c.op_flops += flops
                c.bytes += nbytes
                c.add_storages(_outputs(out))
                return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in _COPIES and _crosses(func, args, out):
            # a table the Python code builds on the host (whisper's positions,
            # cached a process): bus bytes, not a storage of the step's
            c.h2d_bytes += sum(_nbytes(x) for x in _outputs(out))
            return out
        nbytes = 0
        if not (func.is_view or packet in _FREE):
            nbytes = sum(_nbytes(x) for x in _flat(args, kwargs)) + \
                sum(_nbytes(x) for x in _outputs(out))
        c.op_flops += flops
        c.bytes += nbytes
        c.add_storages(_outputs(out))
        if key is not None:
            kind = metas = None
            if isinstance(out, torch.Tensor):
                metas = [(tuple(out.shape), out.stride(), out.dtype)]
            elif type(out) in (list, tuple) and all(
                    x is None or isinstance(x, torch.Tensor) for x in out):
                kind = type(out)
                metas = [None if x is None else (tuple(x.shape), x.stride(), x.dtype)
                         for x in out]
            if metas is not None:
                self.memo[key] = (kind, metas, flops, nbytes)
        return out

    def _view(self, func, args, kwargs):
        """A view op on ``meta``: memoised as ``as_strided`` of its input
        (the same storage), counted as free."""
        x = args[0]
        try:
            key = (func, x.storage_offset(), _key(args), _key(tuple(sorted(kwargs.items()))))
        except TypeError:
            key = None
        hit = self.memo.get(key) if key is not None else None
        if hit is not None:
            return x.as_strided(*hit)
        out = func(*args, **kwargs)
        if key is not None and isinstance(out, torch.Tensor) and out.dtype == x.dtype \
                and out.untyped_storage()._cdata == x.untyped_storage()._cdata:
            self.memo[key] = (tuple(out.shape), out.stride(), out.storage_offset())
        self.counter.add_storages(_outputs(out))
        return out


class WorkCounter:
    """The FLOPs, bytes and peak live bytes of what runs inside ``with``,
    on tensors of ``device_type``.

    :meth:`add_storages` registers tensors alive before the step (its
    arguments: their storages count as live from the start); every storage
    an op makes inside adds its bytes until it dies. :meth:`kernel` runs a hand
    kernel's plain version uncounted and counts the kernel's own work
    (``kernels/ops.py`` calls it while a counter is installed)."""

    def __init__(self, device_type: str = "meta"):
        self.device_type = device_type
        self.op_flops = 0.0
        self.bytes = 0.0
        self.kernel_flops = 0.0
        self.live = 0
        self.peak = 0
        self.paused = False
        self.data_dependent = 0  # ops whose output shape is the values'
        self.h2d_bytes = 0  # copies between devices: bus traffic, not HBM bytes
        self.folded_trips = 0  # loop trips counted from an earlier trip
        self.kernel_calls: dict[str, int] = {}
        self._refs: dict[int, weakref.ref] = {}

    @property
    def flops(self) -> float:
        return float(self.op_flops) + self.kernel_flops

    # ------------------------------------------------------------- memory
    def add_storages(self, tensors) -> int:
        """Add the storages of ``tensors`` not yet live; returns the bytes added."""
        added = 0
        for x in tensors:
            st = x.untyped_storage()
            key = st._cdata
            if key in self._refs:
                continue
            n = int(st.nbytes())
            self._refs[key] = weakref.ref(st, self._dead(key, n))
            self.live += n
            added += n
        if self.live > self.peak:
            self.peak = self.live
        return added

    def _dead(self, key: int, n: int):
        def gone(_ref):
            if self._refs.pop(key, None) is not None:
                self.live -= n
        return gone

    # ------------------------------------------------------------- kernels
    def kernel(self, name: str, fn, args):
        """Run ``fn(*args)`` (a hand kernel's plain version) with nothing of
        it counted, then count the kernel's own work and its outputs."""
        self.paused = True
        try:
            out = fn(*args)
        finally:
            self.paused = False
        flops, nbytes = kernel_work(name, args)
        self.kernel_flops += flops
        self.bytes += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self.add_storages(_outputs(out))
        return out

    # ------------------------------------------------------------- loops
    def can_fold(self, tensors) -> bool:
        """Whether a loop over ``tensors`` may run one trip for all: ``meta``
        tensors, and no gradient recorded (the backward would see one trip)."""
        return self.device_type == "meta" and not (
            torch.is_grad_enabled() and any(t.requires_grad for t in tensors))

    def fold(self, n: int):
        """Trip 0 of a loop of ``n`` trips that run the same ops on the
        same shapes and carry their state from trip to trip (nothing
        appended, no collective): its counts, taken once more for each of
        the others. The peak is a trip's, whatever the count of trips."""
        if n <= 0:
            return
        before = (self.op_flops, self.bytes, self.kernel_flops, dict(self.kernel_calls))
        yield 0
        self.op_flops += (n - 1) * (self.op_flops - before[0])
        self.bytes += (n - 1) * (self.bytes - before[1])
        self.kernel_flops += (n - 1) * (self.kernel_flops - before[2])
        for k, v in list(self.kernel_calls.items()):
            self.kernel_calls[k] = v + (n - 1) * (v - before[3].get(k, 0))
        self.folded_trips += n - 1

    # ------------------------------------------------------------- context
    def __enter__(self):
        from repro_torch.kernels import ops

        if ops.COUNTER is not None:
            raise RuntimeError("a WorkCounter is already installed")
        self._mode = _Counting(self)
        self._mode.__enter__()
        ops.COUNTER = self
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        ops.COUNTER = None
        self._mode.__exit__(*exc)
        return False
