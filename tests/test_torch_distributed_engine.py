"""The port's edge-sharded backend against itself, over gloo on the CPU.

Rank-count cases are parameters of one test each, so that each counts. The
graph and config are ``tests/torch_dist_check.py``'s: ego-facebook at scale
0.05, ``SummaryConfig(T=5, k_frac=0.3)``, the compact grouping with the
port's own seeded draws.

  * the compact grouping at P = 1, 2, 4 gives the partition, ``size_bits``
    and ``nmerges`` of a process with no group, round for round (``re1``
    within ``rtol=1e-6``: its partial sums are added in rank order);
  * the engine (``driver_chunk`` 8 and 1, the ξ = 0 and drop-all finalize
    branches) equals the per-round loop over ``step`` bit for bit;
  * a resume from the first committed step equals the uninterrupted run,
    on the same 4 ranks and on 2;
  * a SIGTERM on one rank stops every rank at the same committed step, and
    a resume on 2 ranks finishes as an uninterrupted run does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_dist_check as tdc

torch.set_num_threads(1)


def _same_run(got: dict, want: dict, label: str, history: bool = True) -> None:
    assert got["iterations"] == want["iterations"], label
    assert got["last"] == want["last"], label
    assert got["final"] == want["final"], label
    np.testing.assert_array_equal(got["node2super"], want["node2super"], err_msg=label)
    np.testing.assert_array_equal(got["size"], want["size"], err_msg=label)
    if history:
        assert got["history"] == want["history"], label


def _same_partition(got: dict, want: dict, label: str) -> None:
    """Two runs on different rank counts: the same rounds, partition and
    integer results; their RE sums are added over other partials."""
    assert got["iterations"] == want["iterations"], label
    np.testing.assert_array_equal(got["node2super"], want["node2super"], err_msg=label)
    np.testing.assert_array_equal(got["size"], want["size"], err_msg=label)
    for k in ("size_bits", "size_bits_before", "num_superedges", "num_supernodes",
              "dropped", "xi"):
        assert got["final"][k] == want["final"][k], (label, k)
    np.testing.assert_allclose(got["final"]["re1"], want["final"]["re1"], rtol=1e-6)


@pytest.fixture(scope="module")
def alone():
    """Five compact rounds in this process, with no process group."""
    return tdc._rounds(tdc._backend(1, 0, "compact"))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_compact_rounds_do_not_depend_on_the_rank_count(alone, world):
    res = tdc.spawn(world, "case_invariance")
    for r, got in enumerate(res):
        for t in range(tdc.ROUNDS):
            label = f"P={world} rank {r} round {t + 1}"
            np.testing.assert_array_equal(got["node2super"][t], alone["node2super"][t],
                                          err_msg=label)
            st, want = got["stats"][t], alone["stats"][t]
            for k in ("size_bits", "nmerges", "num_supernodes", "num_superedges",
                      "overflow"):
                assert st[k] == want[k], (label, k, st[k], want[k])
            np.testing.assert_allclose(st["re1"], want["re1"], rtol=1e-6, err_msg=label)
    assert sum(s["nmerges"] for s in alone["stats"]) > 0


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    ckdir = str(tmp_path_factory.mktemp("dist_engine") / "ck")
    res = tdc.spawn(tdc.N_DEV, "case_engine", ckdir=ckdir)
    for r in range(1, tdc.N_DEV):  # the same results on every rank
        for tag in tdc.ENGINE_CASES:
            _same_run(res[r][tag]["engine"], res[0][tag]["engine"], f"rank {r} {tag}")
    return res[0], ckdir


@pytest.mark.parametrize("case", list(tdc.ENGINE_CASES))
def test_engine_equals_the_per_round_loop(engine, case):
    """SummaryEngine over the backend (chunks of driver_chunk rounds, one
    read-back a round, finalize with salt t + 1) against ``step`` called
    round by round and ``sparsify`` after it."""
    got = engine[0][case]
    _same_run(got["engine"], dict(got["loop"], history=None), case, history=False)
    if case == "xi0":
        assert got["engine"]["iterations"] == 1 and got["engine"]["final"]["dropped"] == 0
    if case == "drop-all":
        fin = got["engine"]["final"]
        assert fin["dropped"] > 0 and fin["num_superedges"] == 0
    if case == "chunk1":
        assert got["engine"]["history"] == engine[0]["chunk8"]["engine"]["history"]


@pytest.mark.parametrize("world", [4, 2])
def test_resume_from_the_first_committed_step(engine, world):
    """driver_chunk 2, a save at every chunk boundary, every step after the
    first deleted: the resumed run equals the uninterrupted one, on the 4
    ranks that wrote the checkpoint and on 2."""
    res, ckdir = engine
    golden = res["resume"]["golden"]
    first = res["resume"]["steps"][0]
    assert res["resume"]["saves"] >= 2
    if world == 4:
        resumed = res["resume"]["resumed"]
    else:
        out = tdc.spawn(2, "case_resume", ckdir=ckdir + "-p2", driver_chunk=2)
        resumed = out[0]["resumed"]
        _same_run(out[1]["resumed"], resumed, "rank 1")
        # on 2 ranks the resumed run is the uninterrupted 2-rank run, and the
        # partition is the 4-rank one
        _same_run(resumed, out[0]["golden"], "P=2 golden", history=False)
    assert resumed["resumed_from"] == first
    if world == 4:
        _same_run(resumed, golden, "resume on 4")
    else:
        _same_partition(resumed, golden, "resume on 2 against the 4-rank run")


def test_preemption_on_one_rank_stops_every_rank(tmp_path):
    """Rank 2 alone is signalled during round 2: every rank stops with
    Preempted at step 2, which is committed; a resume on 2 ranks equals the
    uninterrupted run."""
    ckdir = str(tmp_path / "ck")
    res = tdc.spawn(tdc.N_DEV, "case_preempt", ckdir=ckdir, signal_rank=2,
                    signal_round=2)
    assert [r["stopped"] for r in res] == [2] * tdc.N_DEV
    assert [r["signals"] for r in res] == [0, 0, 1, 0]
    assert all(r["committed"] == [2] for r in res)
    out = tdc.spawn(2, "case_resume", ckdir=ckdir, driver_chunk=1)
    for r in range(2):
        assert out[r]["resumed"]["resumed_from"] == 2
        _same_run(out[r]["resumed"], out[r]["golden"], f"rank {r}", history=False)
        _same_partition(out[r]["resumed"], res[0]["golden"], f"rank {r} against P=4")
