"""The port's multi-host slice against the reference (``repro.launch.mesh``,
``repro.dist.compress``, ``tests/multihost_check.py``) on the CPU.

* The bootstrap: the flags' precedence, the no-op world of one, the
  reference's ``ValueError``s (the reference's own function on the same
  inputs), and a missing peer failing the rendezvous within its timeout.
* The launcher: the bootstrap's flags without ``--distributed`` are refused,
  and so is a bootstrapped fleet on a graph with no CSR cache.
* The codecs in process, float32 and bfloat16 leaves: ``encode_int8``,
  ``decode_int8``, ``encode_topk`` bit for bit (ties to the lower index),
  ``payload_bytes`` and the flatten order equal.
* ``compressed_all_reduce`` at 2 and 4 gloo ranks against the reference's
  ``compressed_allreduce`` on a 2- and 4-device XLA host mesh (a
  subprocess) with the same per-rank contributions: wire bytes and
  residuals equal, sums within ``rtol=1e-5``; all P ranks in one process
  (``RankSet(ranks=P)``) equal to the P-process run bit for bit for the
  codecs; ``none`` is gloo's all-reduce, which adds in its own order (at 4
  ranks not in rank order), held within the dtype's bound.
* ``tests/torch_multihost_check.py`` with 2 processes (all four legs), and
  its feed accounting against the reference's ``tests/multihost_check.py``
  multihost leg on 2 devices, which runs beside it from the module's start.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_wire_check as wire
from repro.dist import compress as R
from repro.launch import mesh as rmesh
from repro_torch.core.convert import tree_from_numpy
from repro_torch.core.query_engine import RankSet
from repro_torch.dist import compress as C
from repro_torch.graphs import generate, load_graph
from repro_torch.graphs.feed import shard_edges_from_cache, shard_edges_from_cache_multihost
from repro_torch.graphs.io import write_edge_list
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import summarize as launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
T_ROUNDS = 4

torch.set_num_threads(1)


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              tmesh.COORDINATOR_ENV, tmesh.NUM_PROCESSES_ENV, tmesh.PROCESS_ID_ENV):
        env.pop(k, None)
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _edge_list(path: str) -> str:
    """ego-facebook at scale 0.05 as SNAP text."""
    src, dst, v = generate("ego-facebook", seed=0, scale=0.05)
    write_edge_list(path, src, dst, v)
    return path


@pytest.fixture(scope="module", autouse=True)
def reference_gate(tmp_path_factory):
    """The reference's ``tests/multihost_check.py`` on 2 processes × 1 device,
    started when the module's first test starts (it runs about 50 s beside
    the others); its workdir keeps every process's launcher JSON."""
    tmp = tmp_path_factory.mktemp("reference_gate")
    edge_list = _edge_list(str(tmp / "g.txt"))
    workdir = tmp / "wd"
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "multihost_check.py"), "--edge-list",
         edge_list, "--T", str(T_ROUNDS), "--driver-chunk", "1", "--num-processes", "2",
         "--devices-per-process", "1", "--skip-wire", "--workdir", str(workdir),
         "--timeout", "240"],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, workdir
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# ---------------------------------------------------------------------------
# The bootstrap
# ---------------------------------------------------------------------------

# (arguments, SSUMM_* environment): the reference's outcomes on each
BOOTSTRAP_CASES = [
    ((None, None, None), {}),
    ((None, 1, None), {}),
    (("localhost:1", 1, 0), {}),
    ((None, None, None), {"SSUMM_NUM_PROCESSES": "1", "SSUMM_COORDINATOR": "h:2"}),
    ((None, 2, 0), {}),
    (("localhost:1", 2, None), {}),
    ((None, None, None), {"SSUMM_NUM_PROCESSES": "3", "SSUMM_PROCESS_ID": "1"}),
    (("h:1", None, None), {"SSUMM_NUM_PROCESSES": "2"}),
    ((None, 0, None), {"SSUMM_NUM_PROCESSES": "4"}),
]


def _outcome(fn, args, monkeypatch, env):
    for k in (tmesh.COORDINATOR_ENV, tmesh.NUM_PROCESSES_ENV, tmesh.PROCESS_ID_ENV):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        info = fn(*args)
    except ValueError as exc:
        return ("ValueError", str(exc))
    return ("info", info.initialized, info.coordinator, info.process_count,
            info.process_index)


@pytest.mark.parametrize("args,env", BOOTSTRAP_CASES)
def test_bootstrap_no_op_and_errors_equal_the_reference(args, env, monkeypatch):
    want = _outcome(rmesh.bootstrap_distributed, args, monkeypatch, env)
    got = _outcome(lambda *a: tmesh.bootstrap_distributed(*a, device="cpu"), args,
                   monkeypatch, env)
    assert got == want
    if got[0] == "info":
        assert not torch.distributed.is_initialized()


def test_flag_precedence_arguments_then_environment(monkeypatch):
    monkeypatch.setenv(tmesh.COORDINATOR_ENV, "envhost:9")
    monkeypatch.setenv(tmesh.NUM_PROCESSES_ENV, "4")
    monkeypatch.setenv(tmesh.PROCESS_ID_ENV, "3")
    assert tmesh.resolve_flags() == ("envhost:9", 4, 3)
    assert tmesh.resolve_flags("arg:1", 2, 1) == ("arg:1", 2, 1)
    assert tmesh.resolve_flags(None, 8, None) == ("envhost:9", 8, 3)
    assert tmesh.resolve_flags("arg:1", 1, 5) == (None, 1, 0)  # one process: no-op
    info = tmesh.bootstrap_distributed(device="cpu", num_processes=1)
    assert info.asdict() == {"initialized": False, "coordinator": None, "process_count": 1,
                             "process_index": 0, "device": "cpu"} and info.is_main


def test_a_missing_peer_fails_the_rendezvous_within_its_timeout():
    code = ("from repro_torch.launch import mesh\n"
            "mesh.TIMEOUT_S = 3.0\n"
            f"mesh.bootstrap_distributed('localhost:{_free_port()}', 2, 0, device='cpu')\n")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and time.perf_counter() - t0 < 60, proc.stderr[-2000:]


def test_launcher_refuses_the_flags_without_distributed(capsys):
    with pytest.raises(SystemExit) as exc:
        launch.main(["--device", "cpu", "--dataset", "ego-facebook", "--scale", "0.05",
                     "--coordinator", "localhost:1", "--num-processes", "2",
                     "--process-id", "0"])
    assert exc.value.code == 2
    assert "--coordinator/--num-processes only make sense with --distributed" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="needs --coordinator and --process-id"):
        launch.main(["--device", "cpu", "--distributed", "--num-processes", "2"])


def test_bootstrapped_fleet_refuses_a_graph_without_a_cache():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.summarize", "--distributed", "--device",
         "cpu", "--dataset", "ego-facebook", "--scale", "0.05", "--T", "2",
         "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id",
         str(i)], env=_env(), cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 1, err[-2000:]
        assert "multi-process summarize needs a CSR-cached graph" in err
        assert "{" not in out


def test_multihost_feed_alone_is_the_cache_feed(tmp_path):
    """Without a group spanning processes the multi-host feed is the cache
    feed (the reference's on a one-process mesh); with one, only its name and
    ``process_count`` differ (the gate below)."""
    g = load_graph(_edge_list(str(tmp_path / "g.txt")))
    for n in (1, 3, 4):
        for r in range(n):
            a = shard_edges_from_cache(g.cache_dir, r, n, "cpu")
            b = shard_edges_from_cache_multihost(g.cache_dir, r, n, "cpu")
            assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
            assert a.stats == b.stats and b.stats.path == "cache-mmap"
            assert b.stats.process_count == 1 and b.stats.local_shards == 1


# ---------------------------------------------------------------------------
# The codecs in process
# ---------------------------------------------------------------------------


def _tree(rng, dtype) -> dict:
    """Leaves that exercise ceil(ratio·n), a scalar, zeros and ties."""
    return {"w": rng.normal(size=(33, 7)).astype(dtype),
            "b": rng.normal(size=(13,)).astype(dtype),
            "s": np.array(rng.normal(), dtype),
            "z": np.zeros((5,), dtype),
            "ties": np.array([1, -2, 2, 0.5, -2, 1, 2, -1, 0.5, 2], dtype)}


def _np(x) -> np.ndarray:
    """A reference array or a port tensor as numpy; bfloat16 widened to
    float32 (exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _same_bits(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16], ids=["float32", "bfloat16"])
def test_codecs_equal_the_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(3)
    for _ in range(5):
        tree = _tree(rng, dtype)
        err = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32) for k, v in tree.items()}
        err["ties"][:] = 0.0  # keep the ties in the accumulated signal
        jt = {k: jnp.asarray(v) for k, v in tree.items()}
        je = {k: jnp.asarray(v) for k, v in err.items()}
        tt, te = tree_from_numpy(tree, "cpu"), tree_from_numpy(err, "cpu")
        assert [x.dtype for x in C.tree_leaves(tt)] == [getattr(torch, np.dtype(dtype).name)] * 5
        q, s = R.encode_int8(jt)
        q2, s2 = C.encode_int8(tt)
        d, d2 = R.decode_int8(q, s), C.decode_int8(q2, s2)
        for k in tree:
            assert _same_bits(q[k], q2[k]) and _same_bits(s[k], s2[k]), k
            assert _same_bits(d[k], d2[k]), k
        for e1, e2 in ((None, None), (je, te)):
            for ratio in (0.1, 0.35):
                sent, res = R.encode_topk(jt, e1, ratio)
                sent2, res2 = C.encode_topk(tt, e2, ratio)
                for k in tree:
                    assert _same_bits(sent[k], sent2[k]) and _same_bits(res[k], res2[k]), k
                    assert torch.equal(sent2[k].float() + res2[k],
                                       tt[k].float() + (te[k] if e2 else 0.0)), k
        for kind in C.KINDS:
            for ratio in (0.05, 0.1, 0.35):
                assert C.payload_bytes(tt, C.CompressConfig(kind, ratio)) == \
                    R.payload_bytes(jt, R.CompressConfig(kind, ratio))


def test_ties_go_to_the_lower_index_as_jax_top_k():
    flat = np.array([1.0, -3.0, 3.0, 2.0, 3.0, -3.0, 0.0], np.float32)
    for k in range(1, 8):
        want = np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(flat)), k)[1])
        assert C._topk_index(torch.from_numpy(flat), k).tolist() == want.tolist()


def test_flatten_order_is_jax_order():
    rng = np.random.default_rng(0)
    tree = {"z": [np.ones(2, np.float32), (np.zeros(3, np.float32), None)],
            "a": {"y": rng.normal(size=4).astype(np.float32),
                  "b": np.array(5.0, np.float32)},
            "m": None}
    want = [np.asarray(x) for x in jax.tree.leaves(tree)]
    got = C.tree_leaves(tree_from_numpy(tree, "cpu"))
    assert [x.shape for x in want] == [tuple(x.shape) for x in got]
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(want, got))
    twice = C.tree_map(lambda x: 2 * x, tree_from_numpy(tree, "cpu"))
    assert list(twice) == ["a", "m", "z"] and twice["m"] is None
    assert twice["z"][1][1] is None and isinstance(twice["z"][1], tuple)
    assert np.array_equal(twice["a"]["y"].numpy(), 2 * tree["a"]["y"])
    with pytest.raises(ValueError):
        C.CompressConfig("fp8")


# ---------------------------------------------------------------------------
# The all-reduce across gloo ranks, against the reference's on a host mesh
# ---------------------------------------------------------------------------

# leaf -> dtype; the bfloat16 stacks are drawn as float32 and rounded to
# bfloat16 first, so both packages cast them exactly
DTYPES = {"w": "float32", "b": "bfloat16", "s": "float32", "h": "bfloat16"}
SHAPES = {"w": (33, 7), "b": (13,), "s": (), "h": (40,)}

_REFERENCE = r"""
import json, sys
import numpy as np, ml_dtypes
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.dist import shard_map
from repro.dist.compress import CompressConfig, compressed_allreduce

inp = np.load(sys.argv[1])
dtypes = json.loads(sys.argv[3])
out = {}
for n in (2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    spec = NamedSharding(mesh, P("data"))
    dt = {k: ml_dtypes.bfloat16 if d == "bfloat16" else np.float32 for k, d in dtypes.items()}
    x = {k: jax.device_put(inp[f"g{n}_{k}"].astype(dt[k]), spec) for k in dtypes}
    e = {k: jax.device_put(inp[f"e{n}_{k}"], spec) for k in dtypes}
    for kind in ("none", "int8", "topk"):
        cfg = CompressConfig(kind, topk_ratio=0.1)

        def body(x, e):
            g = jax.tree.map(lambda a: jnp.squeeze(a, 0), x)
            err = jax.tree.map(lambda a: jnp.squeeze(a, 0), e)
            s, ne, wb = compressed_allreduce(g, err, cfg, ("data",))
            return s, jax.tree.map(lambda a: a[None], ne), wb

        fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P(), P("data"), P()), check_vma=False))
        summed, new_err, wb = fn(x, e)
        out[f"{n}_{kind}_wire"] = np.float64(wb)
        for k in dtypes:
            out[f"{n}_{kind}_sum_{k}"] = np.asarray(summed[k]).astype(np.float32)
            out[f"{n}_{kind}_err_{k}"] = np.asarray(new_err[k]).astype(np.float32)
np.savez(sys.argv[2], **out)
"""


def _contributions(p: int, seed: int) -> tuple[dict, dict]:
    """``[p, *shape]`` float32 stacks a leaf (bfloat16 leaves exactly
    representable) and the ranks' incoming residuals; the tied leaf ``h``
    keeps a zero residual so its ties reach the top-k."""
    rng = np.random.default_rng(seed)
    g, e = {}, {}
    for k, shp in SHAPES.items():
        x = (rng.normal(size=(p,) + shp) if k != "h"
             else rng.choice([-2.0, -1.0, 0.5, 1.0, 2.0], size=(p,) + shp))
        x = x.astype(np.float32)
        if DTYPES[k] == "bfloat16":
            x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        g[k] = x
        e[k] = (np.zeros if k == "h" else lambda s: rng.normal(size=s) * 0.1)(
            (p,) + shp).astype(np.float32)
    return g, e


def _sums_close(got, want, stack, dtype: str) -> None:
    """Two all-reduce sums of ``stack``'s P rows that add in different orders.
    float32: the reference wire check's ``rtol=1e-5, atol=1e-5``. bfloat16
    (the backend adds in bfloat16): each order is within ``(P − 1)·u·Σ|x|`` of
    the exact sum, ``u = 2⁻⁸`` bfloat16's unit roundoff, so two orders are
    within twice that."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        bound = 2 * (stack.shape[0] - 1) * 2.0 ** -8 * np.abs(stack).sum(axis=0)
        assert np.all(np.abs(got - want) <= bound), (got, want)


@pytest.fixture(scope="module")
def reference_allreduce(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("allreduce")
    inp = {}
    for n in (2, 4):
        g, e = _contributions(n, seed=n)
        inp.update({f"g{n}_{k}": v for k, v in g.items()})
        inp.update({f"e{n}_{k}": v for k, v in e.items()})
    np.savez(tmp / "in.npz", **inp)
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"),
                           str(tmp / "out.npz"), json.dumps(DTYPES)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_all_reduce_across_gloo_ranks_equals_the_reference(world,
                                                                      reference_allreduce):
    g, e = _contributions(world, seed=world)
    per_rank = wire.spawn(world, "case_allreduce", contribs=g, dtypes=DTYPES, errs=e)
    one = wire.allreduce_record(RankSet(torch.device("cpu"), ranks=world),
                                wire.rank_trees(g, DTYPES, "cpu"),
                                [{k: torch.from_numpy(np.array(v[r])) for k, v in e.items()}
                                 for r in range(world)])
    ref = reference_allreduce
    template = tree_from_numpy({k: np.zeros(s, np.float32) for k, s in SHAPES.items()}, "cpu")
    for k in DTYPES:
        template[k] = template[k].to(getattr(torch, DTYPES[k]))
    for kind in wire.KINDS:
        priced = world * C.payload_bytes(template, C.CompressConfig(kind, wire.RATIO))
        assert ref[f"{world}_{kind}_wire"] == priced, kind
        for r, rec in enumerate(per_rank):
            got = rec[kind]
            assert got["wire"] == priced, (kind, r)
            for k in DTYPES:
                # every rank holds the same sum; the codecs add in rank order,
                # the same bits as all P ranks run in one process, while "none"
                # is gloo's all-reduce, which adds in its own order
                assert got["sum"][k].tobytes() == per_rank[0][kind]["sum"][k].tobytes()
                if kind == "none":
                    _sums_close(got["sum"][k], one[kind]["sum"][k], g[k], DTYPES[k])
                    _sums_close(got["sum"][k], ref[f"{world}_{kind}_sum_{k}"], g[k], DTYPES[k])
                else:
                    assert got["sum"][k].tobytes() == one[kind]["sum"][k].tobytes(), (kind, k)
                    np.testing.assert_allclose(got["sum"][k], ref[f"{world}_{kind}_sum_{k}"],
                                               rtol=1e-5, atol=1e-6)
                if kind == "topk":  # the residual is rank r's own, exactly
                    want = ref[f"{world}_{kind}_err_{k}"][r]
                    assert np.array_equal(got["residual"][0][k], want), (k, r)
                    assert np.array_equal(one[kind]["residual"][r][k], want), (k, r)
        assert one[kind]["wire"] == priced


# ---------------------------------------------------------------------------
# The four-leg gate, beside the reference's
# ---------------------------------------------------------------------------


def test_multihost_gate_passes_and_feeds_as_the_reference(tmp_path, reference_gate):
    edge_list = _edge_list(str(tmp_path / "g.txt"))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_multihost_check.py"),
         "--edge-list", edge_list, "--T", str(T_ROUNDS), "--num-processes", "2",
         "--workdir", str(tmp_path / "wd"), "--timeout", "240"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    rep = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert rep["ok"] and rep["errors"] == []
    legs = rep["legs"]
    assert legs["resume"]["outcome"] == "resumed"
    assert legs["resume"]["kill_rcs"] == [75, 75] and legs["resume"]["resume_rcs"] == [0, 0]
    assert legs["wire"]["rcs"] == [0, 0] and legs["multihost"]["rcs"] == [0, 0]
    assert legs["golden"]["digests"].startswith("node2super=")
    for i, p in enumerate(legs["multihost"]["procs"]):
        assert p["process_index"] == i and p["feed_path"] == "cache-mmap-multihost"
        assert p["feed_local_shards"] == 1
        assert p["feed_bytes_copied"] == 2 * p["feed_shard_bytes"] == \
            2 * p["feed_peak_staging_bytes"]

    ref_proc, workdir = reference_gate
    out, err = ref_proc.communicate(timeout=400)
    assert ref_proc.returncode == 0, out[-4000:] + err[-4000:]
    assert json.loads(out[out.index("{"):])["ok"]
    ref = [json.loads((workdir / f"mh_p{i}.out").read_text()[
        (workdir / f"mh_p{i}.out").read_text().index("{"):]) for i in range(2)]
    port = legs["multihost"]["procs"]
    for r, p in zip(ref, port):
        assert r["feed_path"] == p["feed_path"] and r["feed_local_shards"] == 1
        for k in ("feed_shard_rows", "feed_shard_bytes", "feed_peak_staging_bytes",
                  "feed_bytes_copied"):
            assert p[k] == r[k], k
    assert sum(p["feed_bytes_copied"] for p in port) == \
        sum(r["feed_bytes_copied"] for r in ref)
