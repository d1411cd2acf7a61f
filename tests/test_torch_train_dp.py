"""Multi-rank training of the port (``repro_torch.launch.train`` over gloo
ranks, ``dist/data_parallel.py``, the MoE block under a data-parallel
group) against the reference's trainer on a multi-device XLA host mesh.

The reference side runs in two subprocesses with 4 XLA host devices
(``tests/torch_train_dp_check.py reference``), started when the module
starts; the port's side in spawned gloo ranks (2 and 4 processes). Both
start from the reference's weights (``lm_params_from_numpy``).

* The rows a rank holds: the reference's global microbatches reassembled
  at ``accum`` 1 and 2, and ``SyntheticTokens.batch_for_rank`` at 1; where
  P does not divide a microbatch every rank takes the whole batch (the
  reference's shape-aware sharding replicates it), and the step is the
  single-device step, bit for bit.
* The trainer at 2 and 4 ranks against the reference trainer (``plan_mesh(P,
  want_model=1)``) on a 2- and 4-device mesh: h2o-danube and granite-moe
  smoke, each at both world sizes and at ``--accum`` 1 and 2; danube with
  ``--compress int8`` (P = 2) and ``topk`` (P = 4), the wire bytes equal to
  the reference's and to ``P × payload_bytes``; per-step
  losses within rtol 1e-5; every rank holds the same losses and parameters;
  two 4-rank runs of granite are equal bit for bit.
* Granite's MoE block under the group at 2 and 4 ranks against the
  reference's jitted ``apply_moe_gspmd(..., rules)`` on a ``(P, 1)`` data
  mesh at a capacity where records drop: ``y`` within 1e-5, ``moe_aux``
  (the mean of the ranks' terms) within 1e-6, ``moe_drop_frac`` equal; the
  rank-local block (no group) parts from it.
* A preemption signal on one of 2 ranks stops both at the same step; the
  run resumes from rank 0's checkpoint, equal to the uninterrupted one.
* The launcher itself under ``torchrun`` and under the bootstrap's flags,
  2 processes each; ``--want-model 2`` at a world of one is the
  ``--want-model 1`` run (tensor parallelism: ``test_torch_train_tp.py``).
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_train_dp_check as chk
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import SyntheticTokens as RefTokens
from repro.data import TokenDatasetConfig as RefTokenConfig
from repro.models import moe as ref_moe
from repro.models.api import build_model as ref_build_model

from repro_torch.configs import get_smoke_config
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.dist.compress import tree_leaves
from repro_torch.dist.data_parallel import DataParallel
from repro_torch.launch import train

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
Y_TOL = 1e-5
AUX_TOL = 1e-6
DANUBE, GRANITE = chk.DANUBE, chk.GRANITE
CASES = [c for part in chk.TRAIN_CASES for c in part]
# the port's runs on each world size: (arch, accum, compress) of CASES, then
# granite at accum 2 once more (the bit-for-bit repeat), then (P = 4) a batch
# of 6 that no microbatch of 4 ranks divides
RUNS = {p: [(c[0], c[2], c[3]) for c in CASES if c[1] == p] for p in (2, 4)}


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "SSUMM_COORDINATOR", "SSUMM_NUM_PROCESSES", "SSUMM_PROCESS_ID", "XLA_FLAGS"):
        env.pop(k, None)
    env.update(extra)
    return env


class Runs:
    """The reference's two parts (subprocesses) and the port's runs on 2 and
    4 gloo ranks (spawned from a thread), all started when the module's first
    test starts."""

    def __init__(self, tmp):
        self.paths = [str(tmp / f"part{i}.pkl") for i in (0, 1)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_train_dp_check.py"),
             "reference", str(i), self.paths[i]], env=_env(), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for i in (0, 1)]
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        weights = ref_weights()
        self.port = {w: self.pool.submit(chk.spawn, w, chk.case_train, runs=_runs(w),
                                         weights=weights) for w in (2, 4)}
        self.tmp = tmp
        self.preempt = self.pool.submit(chk.spawn, 2, chk.case_preempt_resume,
                                        weights=weights[GRANITE], tmp=str(tmp))
        blk = block_weights()
        self.block = {w: self.pool.submit(chk.spawn, w, chk.case_moe_block, params=blk["params"],
                                          x=blk["x"]) for w in (2, 4)}
        self.merged = {}

    def reference(self) -> dict:
        if not self.merged:
            for proc, path in zip(self.procs, self.paths):
                _, err = proc.communicate(timeout=900)
                assert proc.returncode == 0, err[-3000:]
                with open(path, "rb") as f:
                    for k, v in pickle.load(f).items():
                        self.merged.setdefault(k, {}).update(v)
        return self.merged

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        self.pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("train_dp_reference"))
    yield r
    r.close()


@functools.lru_cache(maxsize=None)
def block_weights() -> dict:
    """The reference's granite smoke ``init_moe(PRNGKey(1))`` (float32) and
    the block's input, numpy; the reference side makes the same."""
    cfg = ref_smoke_config(GRANITE)
    p = ref_moe.init_moe(jax.random.PRNGKey(1), cfg, jax.numpy.float32)
    return {"params": {k: np.asarray(getattr(v, "value", v)) for k, v in p.items()},
            "x": chk.block_inputs(cfg.d_model)}


@functools.lru_cache(maxsize=None)
def ref_weights() -> dict:
    """Each arch's reference weights (``model.init(PRNGKey(0))``), numpy."""
    return {a: jax.tree.map(np.asarray, ref_build_model(ref_smoke_config(a)).init(
        jax.random.PRNGKey(0))) for a in (DANUBE, GRANITE)}


def _runs(world: int) -> list:
    runs = [(a, chk.train_argv(a, acc, comp)) for a, acc, comp in RUNS[world]]
    runs.append((GRANITE, chk.train_argv(GRANITE, 2)))
    if world == 4:
        runs.append((DANUBE, chk.train_argv(DANUBE, 1, batch=6)))
    return runs


def _run_of(runs, world: int, arch: str, accum: int, compress: str) -> list:
    """Every rank's result of one run (its first occurrence)."""
    i = RUNS[world].index((arch, accum, compress))
    return [rank[i] for rank in runs.port[world].result()]


# ---------------------------------------------------------------------------
# The rows a rank holds
# ---------------------------------------------------------------------------


class _Fixed(DataParallel):
    """A :class:`DataParallel` posing as rank ``rank`` of ``size`` (no group)."""

    def __init__(self, rank: int, size: int):
        super().__init__("cpu")
        self.rank, self.size = rank, size


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("accum", [1, 2])
def test_the_ranks_rows_reassemble_the_reference_microbatches(world, accum):
    ds = RefTokens(RefTokenConfig(vocab=512, seq_len=chk.SEQ, global_batch=chk.BATCH, seed=0))
    g = ds.batch(3)
    micro = g.reshape((accum, chk.BATCH // accum) + g.shape[1:])  # dist/microbatch.py's split
    parts = []
    for r in range(world):
        dp = _Fixed(r, world)
        assert dp.shards(chk.BATCH, accum)
        local = g[dp.rows(chk.BATCH, accum)]
        parts.append(local.reshape((accum, -1) + g.shape[1:]))  # the local split
        if accum == 1:
            np.testing.assert_array_equal(local, ds.batch_for_rank(3, r, world))
    for i in range(accum):
        np.testing.assert_array_equal(np.concatenate([p[i] for p in parts]), micro[i])


def test_ranks_that_divide_no_microbatch_take_the_whole_batch():
    dp = _Fixed(3, 4)
    assert not dp.shards(6, 2) and not dp.shards(8, 4)
    np.testing.assert_array_equal(dp.rows(6, 2), np.arange(6))


# ---------------------------------------------------------------------------
# The trainer against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-P{c[1]}-accum{c[2]}-{c[3]}")
def test_trainer_across_gloo_ranks_tracks_the_reference(case, runs):
    arch, world, accum, compress = case
    ranks = _run_of(runs, world, arch, accum, compress)
    want = runs.reference()["train"][case]
    got = ranks[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert got["result"]["world"] == world and got["result"]["steps"] == chk.STEPS
    if compress != "none":
        assert got["result"]["wire_bytes_per_step"] == got["result"][
            "wire_bytes_expected"] == want["wire"]
    for other in ranks[1:]:  # every rank holds the same losses; rank 0 the parameters
        assert other["losses"] == got["losses"] and other["rank"] > 0
        assert other["params"] == [] and len(got["params"]) > 0


def test_two_four_rank_runs_are_equal_bit_for_bit(runs):
    first = _run_of(runs, 4, GRANITE, 2, "none")[0]
    second = runs.port[4].result()[0][len(RUNS[4])]
    assert first["losses"] == second["losses"]
    assert all(np.array_equal(a, b) for a, b in zip(first["params"], second["params"]))


def test_a_batch_no_microbatch_of_the_ranks_divides_is_the_single_device_step(runs):
    """P = 4, batch 6: ``plan_mesh`` accumulates 2 microbatches of 3 rows;
    every rank takes the whole batch, as the reference's sharding replicates
    it, and the step is the single-device step with accum 2, bit for bit."""
    got = runs.port[4].result()[0][-1]
    assert got["result"]["world"] == 4
    single = train.train(train.parse_args(chk.train_argv(DANUBE, 2, batch=6)),
                         lm_params_from_numpy(ref_weights()[DANUBE],
                                              get_smoke_config(DANUBE), "cpu"))
    assert got["losses"] == single.losses
    assert all(np.array_equal(a, b.numpy()) for a, b in
               zip(got["params"], tree_leaves(single.params)))


def test_a_signal_on_one_rank_stops_every_rank_and_the_run_resumes(runs):
    """2 ranks, granite smoke at accum 2, checkpoints every 2 steps: a
    preemption signal seen by rank 1 alone (after step 1) stops both ranks
    after the same step; rank 0 commits step 2; both resume from it and end
    equal to the uninterrupted run, bit for bit."""
    ranks = runs.preempt.result()
    whole = ranks[0]["whole"]
    for r in ranks:
        assert r["preempted"]["losses"] == whole["losses"][:2] and r["preempted"]["steps"] == 2
        assert r["resumed"]["losses"] == whole["losses"][2:] and r["resumed"]["steps"] == 4
    # the global state is rank 0's alone
    assert len(whole["params"]) == len(ranks[0]["resumed"]["params"]) > 0
    assert all(np.array_equal(a, b) for a, b in zip(ranks[0]["resumed"]["params"],
                                                    whole["params"]))
    assert all(r["resumed"]["params"] == [] for r in ranks[1:])
    assert sorted(os.listdir(runs.tmp / "b")) == ["step_0000000002", "step_0000000004"]


def test_want_model_2_at_a_world_of_one_is_the_want_model_1_run():
    """``plan_mesh(1, want_model=2)`` is ``(data 1, model 1)``: the run is
    the ``--want-model 1`` run, bit for bit."""
    weights = lm_params_from_numpy(ref_weights()[DANUBE], get_smoke_config(DANUBE), "cpu")
    one = train.train(train.parse_args(chk.train_argv(DANUBE, 1)), weights)
    two = train.train(train.parse_args(chk.train_argv(DANUBE, 1) + ["--want-model", "2"]),
                      weights)
    assert two.result["mesh"] == one.result["mesh"] == {"data": 1, "model": 1}
    assert two.losses == one.losses
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(two.params),
                                                 tree_leaves(one.params)))


# ---------------------------------------------------------------------------
# The MoE block under a data-parallel group
# ---------------------------------------------------------------------------


def _block(world, runs):
    """The reference's block results, and every rank's of the port on
    ``world`` gloo ranks, from the same weights and input."""
    blk = runs.reference()["block"]
    mine = block_weights()
    assert all(np.array_equal(blk["params"][k], v) for k, v in mine["params"].items())
    assert np.array_equal(blk["x"], mine["x"])
    return blk, runs.block[world].result()


@pytest.mark.parametrize("world", [2, 4])
def test_moe_block_under_the_group_gives_the_reference_global_step(world, runs):
    blk, ranks = _block(world, runs)
    want = blk[world]
    assert want["moe_drop_frac"] > 0  # the case is there to drop records
    y = np.concatenate([r["group"]["y"] for r in ranks])
    np.testing.assert_allclose(y, want["y"], rtol=Y_TOL, atol=Y_TOL)
    aux = np.mean([r["group"]["moe_aux"] for r in ranks])
    np.testing.assert_allclose(aux, want["moe_aux"], rtol=AUX_TOL, atol=AUX_TOL)
    assert all(r["group"]["moe_drop_frac"] == want["moe_drop_frac"] for r in ranks)


@pytest.mark.parametrize("world", [2, 4])
def test_the_rank_local_block_parts_from_the_reference(world, runs):
    """The negative control: each rank's block on its own tokens (local
    capacity, slots and load-balance loss) is not the global step."""
    blk, ranks = _block(world, runs)
    want = blk[world]
    y = np.concatenate([r["local"]["y"] for r in ranks])
    aux = np.mean([r["local"]["moe_aux"] for r in ranks])
    drops = [r["local"]["moe_drop_frac"] for r in ranks]
    assert not np.allclose(y, want["y"], rtol=Y_TOL, atol=Y_TOL)
    assert abs(aux - want["moe_aux"]) > AUX_TOL
    assert any(d != want["moe_drop_frac"] for d in drops)


# ---------------------------------------------------------------------------
# The launcher across processes
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_launcher_under_torchrun_and_the_bootstrap_flags():
    """``python -m repro_torch.launch.train`` over 2 gloo processes, under
    ``torchrun`` and under ``--coordinator/--num-processes/--process-id``
    (started together): rank 0 alone prints the JSON, ``world`` 2, the
    same losses both ways, within rtol 1e-5 of the single-device run."""
    argv = [sys.executable, "-m", "repro_torch.launch.train"] + chk.train_argv(GRANITE, 2)
    run = ["torch.distributed.run", "--nproc-per-node", "2", "--master-port",
           str(_free_port()), "-m", "repro_torch.launch.train"]
    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-m"] + run + chk.train_argv(GRANITE, 2),
                              env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(argv + ["--coordinator", coord, "--num-processes", "2",
                                       "--process-id", str(i)],
                               env=_env(GLOO_SOCKET_IFNAME="lo"), cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
              for i in (0, 1)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-3000:]
        outs.append([json.loads(x) for x in out.splitlines() if x.startswith("{")])
    torchrun, boot0, boot1 = outs
    assert len(torchrun) == 1 and len(boot0) == 1 and boot1 == []
    assert torchrun[0]["world"] == boot0[0]["world"] == 2
    assert torchrun[0]["loss_last"] == boot0[0]["loss_last"]
    single = train.main(chk.train_argv(GRANITE, 2))
    np.testing.assert_allclose([boot0[0]["loss_first"], boot0[0]["loss_last"]],
                               [single["loss_first"], single["loss_last"]], rtol=LOSS_RTOL)
