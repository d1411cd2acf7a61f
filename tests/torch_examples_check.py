"""Subprocess side of the tests of the port's SSumM examples and scripts.

The reference (``repro``, JAX) runs here, one process a role, so the JAX
runtime of a role starts with its own device count and nothing of it stays
in the pytest worker:

  * ``python tests/torch_examples_check.py quickstart OUT.npz`` — the
    reference's ``summarize`` on ``examples/quickstart.py``'s graph and
    config, its per-round ``(h, tie)`` draws, and its query answers
    (``expected_degree`` of the five highest-degree nodes, the whole
    ``pagerank_summary`` vector);
  * ``... distributed OUT.npz`` — ``examples/distributed_summarize.py``
    itself, unchanged, on 8 XLA host devices, with ``SummaryEngine.run``
    wrapped to record what it returns (each round's stats, the
    sparsification's), and the compact grouping's draws of its rounds. Its
    merge gain (``repro.kernels.ops.merge_gain``) is wrapped too: its
    operands go to a host callback that does nothing, so XLA keeps the
    merge gain a computation of its own, as it is in the reference's
    single-device round and its kernel tests. Fused into the compiled
    compact step, its ``rel`` moves by a few ulps (9,510 entries of round 4
    on this graph), which breaks an exact tie there: 1,042 merges against
    1,041 (ROADMAP, "The reference as it runs here");
  * ``... edgelist OUTDIR`` — ``scripts/make_edgelist.py``'s ``main`` for
    each of :data:`EDGE_CASES`, writing ``OUTDIR/NAME``.

Each role prints ``ok`` last.
"""

from __future__ import annotations

import os
import runpy
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICKSTART = dict(dataset="ego-facebook", gen_seed=0, scale=0.1, T=20, k_frac=0.3, seed=0)
DIST_DEVICES = 8
# the edge-list writer's cases: file name → arguments but --out
EDGE_CASES = {
    "dblp.txt.gz": ["--dataset", "dblp", "--scale", "0.05", "--shuffle", "--dup-frac",
                    "0.05", "--self-loops", "3", "--one-indexed"],
    "rmat.csv": ["--v", "4096", "--e", "20000", "--no-header"],
}


def _rounds(cfg) -> int:
    """The most rounds a run can draw for: T, then the budget rounds."""
    return cfg.T + cfg.max_extra_iters


def quickstart(out_path: str) -> None:
    import jax

    from repro.core import SummaryConfig, summarize
    from repro.core.queries import expected_degree, pagerank_summary
    from repro.graphs import generate

    q = QUICKSTART
    src, dst, v = generate(q["dataset"], seed=q["gen_seed"], scale=q["scale"])
    cfg = SummaryConfig(T=q["T"], k_frac=q["k_frac"], seed=q["seed"])
    # the reference's key chain (tests/test_torch_reference.py::perm_chain)
    rng = jax.random.PRNGKey(cfg.seed)
    h, tie = [], []
    for _ in range(_rounds(cfg)):
        rng, k = jax.random.split(rng)
        k_shingle, k_tie = jax.random.split(k)
        h.append(np.asarray(jax.random.permutation(k_shingle, v)))
        tie.append(np.asarray(jax.random.permutation(k_tie, v)))
    res = summarize(src, dst, v, cfg)
    deg = np.zeros(v)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)
    nodes = np.argsort(-deg)[:5]
    np.savez(out_path, h=np.stack(h), tie=np.stack(tie), v=v, e=len(src),
             num_supernodes=res.num_supernodes, num_superedges=res.num_superedges,
             iterations=res.iterations_run, size_bits=res.size_bits,
             input_size_bits=res.input_size_bits, re1=res.re1, re2=res.re2,
             deg_nodes=nodes, deg_true=deg[nodes],
             deg_est=[expected_degree(res, int(u)) for u in nodes],
             pagerank=np.asarray(pagerank_summary(res)))


def distributed(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={DIST_DEVICES}"
    import jax

    from repro.core import SummaryConfig
    from repro.core.engine import SummaryEngine
    from repro.graphs import generate
    from repro.kernels import ops as rops

    runs = []
    run, merge_gain = SummaryEngine.run, rops.merge_gain

    def recorded(self, *a, **kw):
        out = run(self, *a, **kw)
        runs.append(out)
        return out

    def unfused(*operands, backend=None):
        jax.debug.callback(lambda *_: None, *operands)
        return merge_gain(*operands, backend=backend)

    SummaryEngine.run, rops.merge_gain = recorded, unfused
    try:
        runpy.run_path(os.path.join(ROOT, "examples", "distributed_summarize.py"),
                       run_name="__main__")
    finally:
        SummaryEngine.run, rops.merge_gain = run, merge_gain
    assert jax.device_count() == DIST_DEVICES and len(runs) == 1
    ran = runs[0]
    _, _, v = generate("dblp", seed=0, scale=0.02)  # the example's graph
    cfg = SummaryConfig(T=10, k_frac=0.3)  # and its config
    # the compact grouping's chain (tests/torch_dist_check.py::_reference)
    rng = jax.random.PRNGKey(cfg.seed)
    h = []
    for _ in range(_rounds(cfg)):
        k_h, _, rng = jax.random.split(rng, 3)
        h.append(np.asarray(jax.random.permutation(k_h, v)))
    keys = ("t", "num_supernodes", "nmerges", "overflow", "size_bits", "re1")
    rec = {f"round_{k}": np.asarray([float(row[k]) for row in ran.history], np.float64)
           for k in keys}
    rec.update({f"sparsify_{k}": float(x) for k, x in ran.finalize["stats"].items()})
    np.savez(out_path, h=np.stack(h), k_bits=ran.k_bits,
             iterations=ran.iterations_run, **rec)


def edgelist(out_dir: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import make_edgelist

    for name, args in EDGE_CASES.items():
        make_edgelist.main(args + ["--out", os.path.join(out_dir, name)])


if __name__ == "__main__":
    role, *rest = sys.argv[1:]
    {"quickstart": quickstart, "distributed": distributed, "edgelist": edgelist}[role](*rest)
    print("ok")
