"""The dry-run's cells against the reference's: every argument leaf's
per-rank shape and the per-rank argument bytes.

The reference runs in three subprocesses started with the module
(``tests/torch_dryrun_check.py``): two with 512 XLA host devices, each
building (not lowering) its cell of half the architectures × applicable
shape on the pod mesh, and on the multipod mesh for one dense and one MoE
architecture; one with 4, compiling three smoke cells on a (2, 2) mesh for
their ``memory_analysis()``. The port builds rank 0's cell of each on ``meta``
(``repro_torch.launch.lowering.build_cell``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import torch_dryrun_check as chk

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import costs
from repro_torch.launch.lowering import (
    argument_leaves,
    build_cell,
    production_plan,
    trace_cell,
    tree_leaves_any,
)
from repro_torch.runtime import plan_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(a, s, "pod") for a in ARCHS for s in applicable_shapes(get_config(a))] + [
    (a, s, "multipod") for a in chk.MULTIPOD_ARCHS for s in applicable_shapes(get_config(a))]


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


class Reference:
    """The three subprocesses, started with the module."""

    JOBS = {"shards0": ("shards", "0"), "shards1": ("shards", "1"), "compiled": ("compiled",)}

    def __init__(self, tmp):
        self.paths = {k: str(tmp / f"{k}.json") for k in self.JOBS}
        self.procs = {k: subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_dryrun_check.py"),
             *self.JOBS[k], self.paths[k]],
            env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k in self.JOBS}
        self.rows = {}

    def get(self, kind: str) -> list:
        """The rows of ``"shards"`` (both parts) or ``"compiled"``."""
        if kind not in self.rows:
            rows = []
            for k in [j for j in self.JOBS if j.startswith(kind)]:
                _, err = self.procs[k].communicate(timeout=600)
                assert self.procs[k].returncode == 0, err[-3000:]
                with open(self.paths[k]) as f:
                    rows += json.load(f)
            self.rows[kind] = rows
        return self.rows[kind]

    def close(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = Reference(tmp_path_factory.mktemp("dryrun_reference"))
    yield ref
    ref.close()


def _argument_bytes(cell) -> int:
    """The bytes of the cell's unique argument storages (``trace``'s
    ``memory.argument_bytes``, without tracing)."""
    return costs.WorkCounter("meta").add_storages(tree_leaves_any(cell.args))


@pytest.mark.parametrize("arch,shape,mesh", CASES)
def test_every_argument_leaf_is_the_reference_devices_shard(reference, arch, shape, mesh):
    sp = SHAPES[shape]
    cell = build_cell(get_config(arch), sp, production_plan(mesh, sp.global_batch))
    row = next(r for r in reference.get("shards")
               if (r["arch"], r["shape"], r["mesh"]) == (arch, shape, mesh))
    want = [(p, tuple(s), d) for p, s, d in row["leaves"]]
    assert sorted(argument_leaves(cell)) == want
    assert _argument_bytes(cell) == row["argument_bytes"]


@pytest.mark.parametrize("arch,name,seq,batch,kind", chk.COMPILED)
def test_argument_bytes_equal_the_compiled_references(reference, arch, name, seq, batch, kind):
    """At (2, 2) the traced cell's ``memory.argument_bytes`` equals the
    reference's compiled ``argument_size_in_bytes``."""
    row = next(r for r in reference.get("compiled") if r["arch"] == arch)
    cell = build_cell(get_smoke_config(arch), ShapeSpec(name, seq, batch, kind),
                      plan_mesh(4, global_batch=batch, want_model=2))
    rec = trace_cell(cell)
    assert rec["memory"]["argument_bytes"] == row["argument_size_in_bytes"] == row["shard_bytes"]
    assert sorted(argument_leaves(cell)) == [(p, tuple(s), d) for p, s, d in row["leaves"]]


def test_the_dry_run_writes_records_emit_tables_renders(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one cheap cell and the
    SSumM round of a small dataset: ``ok`` records with the reference's
    keys, skipped when present, a variant tagged, and
    ``scripts/emit_tables.py`` renders the directory."""
    from repro_torch.launch import dryrun

    out = str(tmp_path / "dr")
    dryrun.main(["--arch", "h2o_danube_1_8b", "--shape", "decode_32k", "--mesh", "pod",
                 "--out", out])
    dryrun.main(["--arch", "h2o_danube_1_8b", "--shape", "decode_32k", "--mesh", "pod",
                 "--out", out, "--variant", "kvseq=none", "--tag", "nokv"])
    dryrun.main(["--ssumm", "ego-facebook", "--mesh", "pod", "--out", out,
                 "--variant", "lean_sort=1", "--variant", "regroup_every=4"])
    recs = {}
    for fn in sorted(os.listdir(out)):
        with open(os.path.join(out, fn)) as f:
            recs[fn] = json.load(f)
    assert len(recs) == 3 and all(r["status"] == "ok" for r in recs.values())
    base = recs["h2o_danube_1_8b__decode_32k__pod.json"]
    nokv = recs["h2o_danube_1_8b__decode_32k__pod_nokv.json"]
    for r in (base, nokv):
        assert {"memory", "cost", "collectives", "roofline", "trace_s", "hardware",
                "collective_log"} <= set(r)
        assert set(r["collectives"]) == {"all-reduce", "all-gather", "reduce-scatter",
                                         "all-to-all", "collective-permute", "total"}
    # the cache kept whole on the model ranks: a rank stores 16 times the KV
    assert nokv["memory"]["argument_bytes"] > base["memory"]["argument_bytes"]
    ss = recs["ssumm_ego-facebook__iteration__pod.json"]
    assert ss["roofline"]["model_flops"] == -(-ss["V"] // 64) * 64 ** 2 * (14 * 128 + 10)
    assert ss["grouping_cost"]["regroup_every"] == 4
    again = dryrun.run_cell("h2o_danube_1_8b", "decode_32k", "pod", out)  # skipped: read back
    assert again == base
    table = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "emit_tables.py"),
                            out], capture_output=True, text=True, check=True).stdout
    assert "| h2o_danube_1_8b | decode_32k | pod |" in table
    assert "| ssumm_ego-facebook | iteration | pod |" in table and "ERROR" not in table
