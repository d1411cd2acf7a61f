"""Checkpoints of the sharded trainer across gloo ranks
(``dist/fsdp.py::Sharded.full_to_host``, the host restore of
``launch/train.py``): danube smoke at ``--want-model 2`` on 2 ranks
(data 1, model 2) and 4 ranks (data 2, model 2), 4 steps, checkpoints
every 2 (``tests/torch_ckpt_ranks_check.py``).

* A save gathers one leaf at a time to rank 0: every rank hands
  ``torch.distributed.gather`` only its own shards (none larger than its
  largest stored shard), only rank 0 receives, and only rank 0 gets the
  global state back, in host memory.
* The checkpoint files are byte-identical to those of the gather they
  replace (every leaf whole on every rank, rank 0 writing) on the same run,
  and the runs' losses are the same bits.
* ``--resume`` from step 2 on the same plan gives the unbroken run's losses
  and step-4 files bit for bit; on another plan ((1, 4) at 4 ranks, (2, 1)
  at 2) the losses of the restore it replaces (the whole state restored
  onto each rank's device, then sharded), bit for bit.
"""

from __future__ import annotations

import filecmp
import functools
import os

import jax
import numpy as np
import pytest
import torch

import torch_ckpt_ranks_check as chk
import torch_train_dp_check as dp_chk
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.api import build_model as ref_build_model

torch.set_num_threads(1)

WORLDS = {2: (2, 1), 4: (2, 4)}  # ranks: (--want-model, the resumed run's)


@functools.lru_cache(maxsize=None)
def weights():
    return jax.tree.map(np.asarray, ref_build_model(ref_smoke_config(chk.DANUBE)).init(
        jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _run(world: int, tmp: str) -> list:
    want_model, other = WORLDS[world]
    return dp_chk.spawn(world, chk.case_save, weights=weights(), tmp=tmp,
                        want_model=want_model, other_model=other)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_ranks")
    return {w: (_run(w, str(tmp / f"P{w}")), tmp / f"P{w}") for w in WORLDS}


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_save_gathers_one_shard_a_leaf_to_rank_zero(world, ranks):
    out, _ = ranks[world]
    for rank, r in enumerate(out):
        assert r["sent"], rank
        biggest = max(int(np.prod(shape)) for shape, _ in r["sent"])
        assert biggest <= r["largest_shard"], rank
        assert set(r["new"]["shards"]) >= {shape for shape, _ in r["sent"]}
        assert all(receives == (rank == 0) for _, receives in r["sent"]), rank
        if rank == 0:
            assert r["new"]["on_host"] and len(r["new"]["params"]) > 0
        else:
            assert r["new"]["params"] == [] and not r["new"]["on_host"]


def _files(d) -> list:
    return sorted(f for f in os.listdir(d) if f.endswith(".npy") or f == "manifest.json")


def _same_bytes(a, b) -> bool:
    return _files(a) == _files(b) and all(
        filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False) for f in _files(a))


@pytest.mark.parametrize("world", list(WORLDS))
def test_the_files_are_the_pre_repair_gathers_bytes(world, ranks):
    out, tmp = ranks[world]
    new, old = out[0]["new"], out[0]["old"]
    assert new["losses"] == old["losses"] and len(new["losses"]) == chk.STEPS
    assert all(np.array_equal(a, b) for a, b in zip(new["params"], old["params"]))
    for step in ("step_0000000002", "step_0000000004"):
        assert _same_bytes(tmp / "new" / step, tmp / "old" / step), step


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_resume_is_bit_for_bit(world, ranks):
    out, tmp = ranks[world]
    for r in out:
        assert r["same"]["losses"] == r["new"]["losses"][2:] and r["same"]["step"] == 4
        assert r["other"]["losses"] == r["other_old"]["losses"] and r["other"]["step"] == 4
        np.testing.assert_allclose(r["other"]["losses"], r["new"]["losses"][2:], rtol=2e-4,
                                   atol=1e-5)
    assert _same_bytes(tmp / "same" / "step_0000000004", tmp / "new" / "step_0000000004")
    assert _same_bytes(tmp / "other" / "step_0000000004",
                       tmp / "other_old" / "step_0000000004")
