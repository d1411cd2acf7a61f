"""The port's mesh planner (``repro_torch.runtime.elastic.plan_mesh``)
against the reference's (``repro.runtime.elastic.plan_mesh``): equal plans
(shape, axes, per-device batch, accumulation) over a grid of device
counts, global batches, TP caps and pod caps, and the survivor shrink of
``tests/test_runtime.py``; the trainer takes ``max(--accum,
plan.accum_steps)``."""

from __future__ import annotations

import dataclasses

import pytest

from repro.runtime import plan_mesh as ref_plan_mesh

from repro_torch.runtime import MeshPlan, plan_mesh

DEVICES = [1, 2, 3, 4, 6, 7, 8, 12, 16, 24, 64, 448, 512]
BATCHES = [1, 3, 6, 8, 32, 100, 256]


@pytest.mark.parametrize("want_model,want_pods", [(1, 1), (4, 1), (16, 1), (16, 2), (8, 4)])
def test_plan_mesh_equals_the_reference(want_model, want_pods):
    for n in DEVICES:
        for batch in BATCHES:
            got = plan_mesh(n, global_batch=batch, want_model=want_model, want_pods=want_pods)
            want = ref_plan_mesh(n, global_batch=batch, want_model=want_model,
                                 want_pods=want_pods)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), (n, batch)
            assert got.n_devices == want.n_devices == n


def test_the_survivor_shrink():
    full = plan_mesh(512, global_batch=256, want_model=16, want_pods=2)
    assert full.shape == (2, 16, 16) and full.axes == ("pod", "data", "model")
    survivor = plan_mesh(448, global_batch=256, want_model=16, want_pods=2)
    want = ref_plan_mesh(448, global_batch=256, want_model=16, want_pods=2)
    assert dataclasses.astuple(survivor) == dataclasses.astuple(want)
    assert survivor.n_devices == 448
    assert 448 % survivor.shape[survivor.axes.index("model")] == 0


def test_a_data_parallel_plan_of_ranks():
    """What the trainer plans for P ranks (``want_model=1``): a ``(P, 1)``
    mesh; accumulation where P does not divide the batch."""
    assert plan_mesh(4, global_batch=8, want_model=1) == MeshPlan((4, 1), ("data", "model"), 2, 1)
    assert plan_mesh(4, global_batch=6, want_model=1) == MeshPlan((4, 1), ("data", "model"), 1, 2)
    assert plan_mesh(4, global_batch=3, want_model=1).accum_steps == 1
