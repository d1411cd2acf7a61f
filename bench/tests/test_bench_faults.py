"""A run with the timed path broken underneath has ``correct`` false.

Each test drives the whole of a run on the CPU (the look for a card skipped)
on a tiny cell, with one fault planted in the program: a round that returns
its state unchanged, the merge gain leaving out half of the groups, a
superedge weight altered where it is produced, the pair cost altered where
it is produced, a neighbour count of the group tables altered where it is
produced. One more run, unbroken, is correct."""

import time

import pytest
import torch

from bench import harness
from conftest import TINY_CELL


def _run(root, break_program=None):
    return harness.run_cell(root, TINY_CELL, 5, 0.01, False, t_start=time.perf_counter(),
                            device="cpu", log=lambda msg: None, break_program=break_program)


def state_unchanged(monkeypatch):
    from repro_torch.core import merge
    from repro_torch.core.types import SummaryState

    real = merge.merge_iteration

    def merge_iteration(src, dst, state, cfg, theta, perms):
        _, stats = real(src, dst, state, cfg, theta, perms)
        return SummaryState(node2super=state.node2super, size=state.size,
                            t=state.t + 1), stats
    monkeypatch.setattr(merge, "merge_iteration", merge_iteration)


def half_the_groups(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.merge_gain

    def merge_gain(*args, **kwargs):
        rel, red = real(*args, **kwargs)
        half = rel.shape[0] // 2
        rel, red = rel.clone(), red.clone()
        rel[half:] = float("-inf")
        red[half:] = 0.0
        return rel, red
    monkeypatch.setattr(ops, "merge_gain", merge_gain)


def weight_altered(monkeypatch):
    from repro_torch.core.engine import LocalBackend

    real = LocalBackend.sparsify_finalize

    def sparsify_finalize(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        first = torch.nonzero(out["keep"])[0, 0]
        out["pair_table"].cnt[first] += 1.0
        return out
    monkeypatch.setattr(LocalBackend, "sparsify_finalize", sparsify_finalize)


def pair_cost_altered(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.pair_cost
    monkeypatch.setattr(ops, "pair_cost",
                        lambda *args, **kwargs: real(*args, **kwargs) * (1.0 + 1e-3))


def table_count_altered(monkeypatch):
    from repro_torch.core import tables

    real = tables.build_group_tables

    def build_group_tables(*args, **kwargs):
        gt = real(*args, **kwargs)
        gt.m[:, 0, 0] += 1.0
        return gt
    monkeypatch.setattr(tables, "build_group_tables", build_group_tables)


@pytest.mark.parametrize("fault", [state_unchanged, half_the_groups, weight_altered,
                                   pair_cost_altered, table_count_altered])
def test_fault_is_not_correct(tiny_root, monkeypatch, fault):
    result = _run(tiny_root, lambda: fault(monkeypatch))
    assert result["correct"] is False
    failed = [k for k, c in result["checks"].items() if c["value"] > c["limit"]]
    assert failed, result["checks"]


def test_unbroken_run_is_correct(tiny_root):
    result = _run(tiny_root)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"summarize_s", "re1", "peak_mem_gib", "setup_s"}
