"""The port's cells (``repro_torch.launch.lowering``), the counterpart of
``tests/test_lowering.py``: every smoke architecture × {train, prefill,
decode} builds a cell and traces it on ``meta`` at plans (1, 1) and
(2, 2); at (1, 1) the counts on ``meta`` equal those of the same step on
CPU tensors; one split decode step's collectives equal what rank 0 of
``models/tp_ranks.py::DecodeRanks`` really gathers and exchanges; a compact
distributed SSumM round on 4 counting ranks issues what a real run of the
same round issues; ``make_rules(..., overrides=)`` gives the reference's
table and raises its errors."""

from __future__ import annotations

import concurrent.futures
import threading
import types

import numpy as np
import pytest
import torch

from repro.dist.sharding import make_rules as ref_make_rules

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.distributed import RankGroup, make_distributed_backend
from repro_torch.core.shingles import SeededPermutations
from repro_torch.core.types import SummaryConfig, init_state
from repro_torch.dist.data_parallel import add_in_order
from repro_torch.dist.sharding import make_rules
from repro_torch.launch.dryrun import assume_all_nonzero, build_ssumm_round
from repro_torch.launch.lowering import build_cell, trace, trace_cell
from repro_torch.models.api import build_model
from repro_torch.models.tp_ranks import DecodeRanks
from repro_torch.runtime import plan_mesh

torch.set_num_threads(1)

SMOKE_SHAPES = [ShapeSpec("smoke_train", 32, 4, "train"),
                ShapeSpec("smoke_prefill", 64, 2, "prefill"),
                ShapeSpec("smoke_decode", 64, 4, "decode")]


def _plan(data: int, model: int, batch: int):
    plan = plan_mesh(data * model, global_batch=batch, want_model=model)
    assert plan.shape == (data, model)
    return plan


@pytest.mark.parametrize("plan_shape", [(1, 1), (2, 2)], ids=lambda p: f"{p[0]}x{p[1]}")
@pytest.mark.parametrize("sp", SMOKE_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_a_cell_traces_on_meta(arch, sp, plan_shape):
    cfg = get_smoke_config(arch)
    cell = build_cell(cfg, sp, _plan(*plan_shape, sp.global_batch))
    rec = trace_cell(cell)
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert rec["memory"]["argument_bytes"] > 0 and rec["memory"]["temp_bytes"] > 0
    assert rec["roofline"]["step_time_bound_s"] > 0
    calls = sum(r["count"] for r in rec["collective_log"])
    if plan_shape == (1, 1):
        assert calls == 0 and rec["collectives"]["total"] == 0
    elif sp.kind == "train":
        assert rec["collectives"]["all-gather"] > 0  # FSDP's views at least
    assert rec["kernel_calls"] == {} and rec["data_dependent_ops"] == 0


def _assert_same_counts(meta, cpu):
    """FLOPs, bytes and memory exactly. A tensor the Python code makes on
    the host and moves to the step's device (gemma's √d scale, whisper's
    sinusoidal positions) is a copy across the bus on ``meta`` (and on a
    card) and none on the CPU: it is counted apart
    (``host_to_device_bytes``), in neither the bytes nor the storages."""
    assert meta["cost"]["flops"] == cpu["cost"]["flops"]
    assert meta["cost"]["bytes_accessed"] == cpu["cost"]["bytes_accessed"]
    assert cpu["cost"]["host_to_device_bytes"] == 0
    assert meta["memory"] == cpu["memory"]


@pytest.mark.parametrize("sp", SMOKE_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_counts_equal_cpu_counts(arch, sp):
    """At (1, 1) the step on ``meta`` counts the FLOPs, bytes and memory of
    the same step on CPU tensors (:func:`_assert_same_counts`)."""
    cfg = get_smoke_config(arch)
    plan = _plan(1, 1, sp.global_batch)
    cpu = trace_cell(build_cell(cfg, sp, plan, device="cpu"))
    meta = trace_cell(build_cell(cfg, sp, plan))
    _assert_same_counts(meta, cpu)


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "whisper_large_v3"])
def test_a_folded_kv_loop_counts_every_trip(arch):
    """A prefill of 2048 positions runs blockwise attention over 8 × 2
    blocks; on ``meta`` (no gradient) one trip of each KV loop is run and
    its count repeated (``ops.trips``): the counts equal the CPU step's,
    where every trip runs."""
    cfg = get_smoke_config(arch)
    sp = ShapeSpec("smoke_prefill_long", 2048, 1, "prefill")
    plan = _plan(1, 1, 1)
    cpu = trace_cell(build_cell(cfg, sp, plan, device="cpu"))
    meta = trace_cell(build_cell(cfg, sp, plan))
    _assert_same_counts(meta, cpu)


def _recorded(group, log: list):
    """Wrap a ``ThreadRank``'s gather and exchange to record what each
    returns (op, shape, dtype)."""
    for name, op in (("gather", "all-gather"), ("exchange", "all-to-all")):
        fn = getattr(group, name)

        def counted(x, fn=fn, op=op):
            out = fn(x)
            log.append((op, tuple(out.shape), str(out.dtype).replace("torch.", "")))
            return out
        setattr(group, name, counted)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_split_decode_steps_collectives_are_what_decode_ranks_move(arch, size):
    cfg = get_smoke_config(arch)
    slots, max_len = 4, 32
    model = build_model(cfg, "cpu")
    ranks = DecodeRanks(model, model.init(0), slots, max_len, size)
    real: list = []
    _recorded(ranks.groups[0], real)
    try:
        ranks.step(torch.arange(slots), torch.tensor(5))
    finally:
        ranks.close()
    cell = build_cell(cfg, ShapeSpec("smoke_decode", max_len, slots, "decode"),
                      _plan(1, size, slots))
    rec = trace(cell.step_fn, cell.args, cell.log)
    traced = [(c.op, c.shape, c.dtype) for c in rec["_calls"]]
    assert real and traced == real
    assert all(c.axis == "model" and c.ranks == tuple(range(size)) for c in rec["_calls"])


# ---------------------------------------------------------------------------
# the distributed SSumM round
# ---------------------------------------------------------------------------


class _Shared:
    def __init__(self, size: int):
        self.size = size
        self.slots = [None] * size
        self.barrier = threading.Barrier(size)


class ThreadGroup(RankGroup):
    """Rank ``rank`` of a :class:`~repro_torch.core.distributed.RankGroup`
    whose ranks are threads of this process: every collective computed from
    every rank's tensor, in rank order."""

    def __init__(self, shared: _Shared, rank: int, log: list | None = None):
        self.device, self.pg, self.active, self.backend = torch.device("cpu"), None, True, None
        self.rank, self.size, self._shared, self.log = rank, shared.size, shared, log

    def _swap(self, x):
        sh = self._shared
        sh.slots[self.rank] = x
        sh.barrier.wait()
        parts = list(sh.slots)
        sh.barrier.wait()
        return parts

    def _note(self, op, out):
        if self.log is not None:
            self.log.append((op, tuple(out.shape), str(out.dtype).replace("torch.", "")))

    def all_reduce(self, x, op):
        y = x.to(torch.int32) if x.dtype == torch.bool else x
        parts = self._swap(y)
        out = {"sum": add_in_order(parts), "max": torch.stack(parts).amax(0),
               "min": torch.stack(parts).amin(0)}[op]
        self._note("all-reduce", out)
        return out.to(x.dtype)

    def all_gather(self, x):
        y = x.to(torch.int32) if x.dtype == torch.bool else x
        out = torch.cat(self._swap(y), dim=0)
        self._note("all-gather", out)
        return out.to(x.dtype)

    def all_to_all(self, buck):
        out = torch.stack([p[self.rank] for p in self._swap(buck)])
        self._note("all-to-all", out)
        return out


def test_a_counted_ssumm_round_issues_a_real_rounds_collectives():
    """The compact round at V = 16,384 (E = 131,072 random edges) on 4
    ranks: rank 0 of a real run (threads exchanging real tensors) and rank
    0 traced on ``meta`` with counting ranks issue the same collectives,
    op for op, shape for shape. No op of the counted step has a
    data-dependent shape (the all-nonzero assumption bounds none)."""
    v, e_target, p, c = 16384, 131072, 4, 32
    rng = np.random.default_rng(0)
    a = rng.integers(0, v, size=3 * e_target)
    b = rng.integers(0, v, size=3 * e_target)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keys = np.unique(lo[lo < hi] * v + hi[lo < hi])[:e_target]
    src, dst = keys // v, keys % v
    e = len(src)
    e_loc = -(-e // p)
    pad = np.full(p * e_loc - e, -1)
    shards = [torch.as_tensor(np.concatenate([x, pad])[r * e_loc:(r + 1) * e_loc])
              for x in (src, dst) for r in range(p)]
    shared, real = _Shared(p), []
    cfg = SummaryConfig(group_size=c)

    def one(r):
        try:
            backend = make_distributed_backend(
                cfg, v, e, grouping="compact", device="cpu",
                perms=SeededPermutations(0, "cpu"),
                group=ThreadGroup(shared, r, real if r == 0 else None))
            return backend.step(shards[r], shards[p + r], init_state(v, "cpu"), 0.0, 1)
        except BaseException:
            shared.barrier.abort()
            raise

    with concurrent.futures.ThreadPoolExecutor(p) as pool:
        states = [f.result() for f in [pool.submit(one, r) for r in range(p)]]
    assert int(states[0][1]["nmerges"]) > 0
    backend, args, log = build_ssumm_round(v, e, p, 0, c)
    with assume_all_nonzero():
        rec = trace(backend.step, args, log)
    traced = [(x.op, x.shape, x.dtype) for x in rec["_calls"]]
    assert real and traced == real
    assert rec["kernel_calls"] == {"merge_gain": 1, "pair_cost": 1}
    assert rec["data_dependent_ops"] == 0


# ---------------------------------------------------------------------------
# the rule table's overrides
# ---------------------------------------------------------------------------

OVERRIDES = [{}, {"seq": "model"}, {"seq": None}, {"kvseq": None},
             {"batch": ("data", "model")}, {"batch": "data+model"}, {"embed": None},
             {"ff": None, "heads": "data"}, {"experts": ("model",)}]


def _normal(val) -> tuple:
    return () if val is None else (val,) if isinstance(val, str) else tuple(val)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("overrides", OVERRIDES, ids=str)
def test_make_rules_overrides_give_the_references_table(overrides, shape, mode):
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    plan = types.SimpleNamespace(shape=shape, axes=axes)
    mesh = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    ov = {k: tuple(v.split("+")) if isinstance(v, str) and "+" in v else v
          for k, v in overrides.items()}
    want = ref_make_rules(mesh, mode, overrides=ov).table
    got = make_rules(plan, mode, overrides=ov).table
    assert got == {k: _normal(v) for k, v in want.items()}


@pytest.mark.parametrize("overrides,error", [
    ({"sequence": "model"}, KeyError), ({"seq": "modell"}, ValueError),
    ({"batch": ("data", "data")}, ValueError), ({"seq": 3}, ValueError),
    ({"batch": ("pod",)}, ValueError)])
def test_make_rules_overrides_raise_the_references_errors(overrides, error):
    axes = ("data", "model")
    plan = types.SimpleNamespace(shape=(16, 16), axes=axes)
    mesh = types.SimpleNamespace(axis_names=axes, shape={"data": 16, "model": 16})
    with pytest.raises(error):
        ref_make_rules(mesh, "serve", overrides=overrides)
    with pytest.raises(error):
        make_rules(plan, "serve", overrides=overrides)


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_parameters_are_a_real_inits_leaves(arch):
    """The parameters of a ``meta`` cell (the family's init on a ``meta``
    model, nothing drawn): the leaves of a real smoke init on the CPU,
    shape and dtype, in the same tree, and ``param_shapes``' shapes."""
    from repro_torch.dist.compress import tree_leaves
    from repro_torch.launch.lowering import init_params
    from repro_torch.models.api import param_shapes

    cfg = get_smoke_config(arch)
    meta = init_params(build_model(cfg, "meta"))
    real = build_model(cfg, "cpu").init(0)
    got = [(tuple(x.shape), x.dtype, x.device.type) for x in tree_leaves(meta)]
    want = [(tuple(x.shape), x.dtype, "meta") for x in tree_leaves(real)]
    assert got == want

    def shapes(tree):
        return {k: shapes(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else tuple(tree.shape)
    assert shapes(meta) == param_shapes(cfg)
