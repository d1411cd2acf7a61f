"""The port's edge-list ingestion against the reference ``repro.graphs.io``.

Both packages read the same files (written by the reference's
``write_edge_list``): the graph, the stats and every cache member must be
the same bytes, a cache written by either must load in the other, freshness
and invalidation must behave the same, and the chunk size must not change
the cache.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from repro.graphs import io as rio
from repro.graphs import synthetic as rsynthetic

from repro_torch.graphs import generate, io as pio, load_graph, write_edge_list
from repro_torch.launch import summarize as launch

torch.set_num_threads(1)

FILES = list(pio.CACHE_MEMBERS) + ["meta.json"]


def _edges(seed=0, v=60, e=200):
    src, dst = rsynthetic.erdos_renyi(v, e, seed=seed)
    return np.asarray(src, np.int64), np.asarray(dst, np.int64), v


def _text(tmp_path, name, text):
    p = os.path.join(tmp_path, name)
    with (gzip.open(p, "wt") if name.endswith(".gz") else open(p, "w")) as f:
        f.write(text)
    return p


def _written(tmp_path, name, **kw):
    src, dst, v = _edges()
    return rio.write_edge_list(os.path.join(tmp_path, name), src, dst, v, **kw)


# name -> a function of tmp_path that writes the file
CASES = {
    "plain": lambda t: _written(t, "g.txt"),
    "gzip": lambda t: _written(t, "g.txt.gz", shuffle=True, seed=3),
    "csv": lambda t: _written(t, "g.csv", shuffle=True),
    "one-indexed": lambda t: _written(t, "g.txt", one_indexed=True, header=False),
    "duplicates-self-loops": lambda t: _written(t, "g.txt", dup_frac=0.3, self_loops=9,
                                                shuffle=True, comment="noisy"),
    "no-header": lambda t: _written(t, "g.el", header=False, shuffle=True),
    "noncontiguous-ids": lambda t: _text(t, "g.txt", "7000 900\n1 5\n900 1\n5 7000\n"),
    "header-comments": lambda t: _text(t, "g.txt", "# SNAP-ish preamble\n% matrix market\n"
                                       "# Nodes: 9 Edges: 3\n\n0\t1\n  2   3  \n1 2\n"),
    "mixed-columns": lambda t: _text(t, "g.txt", "0 1 17 999\n1 2 3\n2,3\n4 1 0.5\n"),
    "empty": lambda t: _text(t, "g.txt", "# Nodes: 0 Edges: 0\n"),
    "empty-no-header": lambda t: _text(t, "g.txt", "# nothing here\n"),
}


def _load_both(tmp_path, path, **kw):
    """The same file loaded by each package into a cache of its own."""
    got = pio.load_graph(path, cache_dir=os.path.join(tmp_path, "port.cache"), **kw)
    want = rio.load_graph(path, cache_dir=os.path.join(tmp_path, "ref.cache"), **kw)
    return got, want


def _read(cache_dir, name):
    with open(os.path.join(cache_dir, name), "rb") as f:
        return f.read()


def _same_graph(got, want):
    assert np.array_equal(np.asarray(got.src), np.asarray(want.src))
    assert np.asarray(got.src).dtype == np.asarray(want.src).dtype == np.int32
    assert np.array_equal(np.asarray(got.dst), np.asarray(want.dst))
    assert got.num_nodes == want.num_nodes
    assert got.source == want.source
    assert got.stats.asdict() == want.stats.asdict()


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_graph_csr_and_cache_bytes_as_the_reference(tmp_path, case):
    path = CASES[case](str(tmp_path))
    got, want = _load_both(tmp_path, path)
    assert got.source == "real"
    _same_graph(got, want)
    for a, b in zip(pio.open_csr(got.cache_dir), rio.open_csr(want.cache_dir)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for name in FILES:
        assert _read(got.cache_dir, name) == _read(want.cache_dir, name), name


@pytest.mark.parametrize("case", ["plain", "duplicates-self-loops", "noncontiguous-ids"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_cache_interoperates_both_ways(tmp_path, case, writer):
    """A cache one package wrote is fresh for the other, which loads it
    without parsing a byte, to the same graph."""
    path = CASES[case](str(tmp_path))
    cdir = os.path.join(tmp_path, "shared.cache")
    first, second = (pio, rio) if writer == "port" else (rio, pio)
    built = first.load_graph(path, cache_dir=cdir)
    assert built.source == "real"
    assert second.cache_is_fresh(cdir, path)
    hit = second.load_graph(path, cache_dir=cdir)
    assert hit.source == "cache" and hit.stats.bytes_parsed == 0
    _same_graph(hit, first.load_graph(path, cache_dir=cdir))
    assert np.array_equal(np.asarray(hit.src), np.asarray(built.src))


def _drop_member(cdir, path):
    os.remove(os.path.join(cdir, "indices.npy"))


def _truncate_member(cdir, path):
    p = os.path.join(cdir, "dst.npy")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 4)


def _bump_version(cdir, path):
    meta_path = os.path.join(cdir, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["version"] = pio.CACHE_VERSION + 1
    with open(meta_path, "w") as f:
        json.dump(meta, f)


def _touch_source(cdir, path):
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))


def _corrupt_meta(cdir, path):
    with open(os.path.join(cdir, "meta.json"), "w") as f:
        f.write("{not json")


@pytest.mark.parametrize("mutate", [_drop_member, _truncate_member, _bump_version,
                                    _touch_source, _corrupt_meta, None])
def test_freshness_and_invalidation_as_the_reference(tmp_path, mutate):
    """Each way a cache goes stale is seen by both packages alike, and a
    load then parses the file again; an intact cache is a hit."""
    path = CASES["gzip"](str(tmp_path))
    cdirs = {}
    for pkg in (pio, rio):
        cdirs[pkg] = os.path.join(tmp_path, f"{pkg.__name__}.cache")
        pkg.load_graph(path, cache_dir=cdirs[pkg])
    if mutate is not None:
        for cdir in cdirs.values():
            mutate(cdir, path)
    fresh = {pkg: pkg.cache_is_fresh(cdir, path) for pkg, cdir in cdirs.items()}
    assert fresh[pio] == fresh[rio] == (mutate is None)
    got = pio.load_graph(path, cache_dir=cdirs[pio])
    want = rio.load_graph(path, cache_dir=cdirs[rio])
    assert got.source == want.source == ("cache" if mutate is None else "real")
    _same_graph(got, want)
    for name in pio.CACHE_MEMBERS:
        assert _read(cdirs[pio], name) == _read(cdirs[rio], name)


@pytest.mark.parametrize("chunk_edges", [3, 64, 10_000])
def test_chunk_size_does_not_change_the_cache(tmp_path, chunk_edges):
    path = CASES["duplicates-self-loops"](str(tmp_path))
    base = pio.load_graph(path, cache_dir=os.path.join(tmp_path, "base.cache"))
    got = pio.load_graph(path, cache_dir=os.path.join(tmp_path, "port.cache"),
                         chunk_edges=chunk_edges)
    want = rio.load_graph(path, cache_dir=os.path.join(tmp_path, "ref.cache"),
                          chunk_edges=chunk_edges)
    assert got.stats.chunks == want.stats.chunks
    assert got.stats.spill_runs == want.stats.spill_runs
    for name in pio.CACHE_MEMBERS:
        assert _read(got.cache_dir, name) == _read(base.cache_dir, name)
        assert _read(got.cache_dir, name) == _read(want.cache_dir, name)


@pytest.mark.parametrize("text,match", [(f"5 {1 << 31}\n", "2\\^31"), ("-3 4\n", "2\\^31"),
                                        ("0 1 7\n3\n", "malformed")])
def test_bad_files_raise_as_the_reference(tmp_path, text, match):
    path = _text(str(tmp_path), "bad.txt", text)
    for pkg in (pio, rio):
        with pytest.raises(ValueError, match=match):
            pkg.load_graph(path, cache_dir=os.path.join(tmp_path, f"{pkg.__name__}.cache"))


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=True, dup_frac=0.2, self_loops=4, seed=5),
                                dict(one_indexed=True, header=False, comment="x")])
@pytest.mark.parametrize("name", ["w.txt", "w.csv.gz"])
def test_write_edge_list_writes_the_reference_bytes(tmp_path, kw, name):
    src, dst, v = _edges(seed=1)
    a = write_edge_list(os.path.join(tmp_path, "port-" + name), src, dst, v, **kw)
    b = rio.write_edge_list(os.path.join(tmp_path, "ref-" + name), src, dst, v, **kw)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_generated_graph_round_trips_through_a_file(tmp_path):
    """A registry stand-in written with noise loads back to ``generate``'s
    edges exactly (ids are already dense, the header keeps V)."""
    src, dst, v = generate("ego-facebook", seed=0, scale=0.05)
    path = write_edge_list(os.path.join(tmp_path, "fb.txt.gz"), src, dst, v, shuffle=True,
                           dup_frac=0.01, self_loops=5)
    g = load_graph(path, chunk_edges=500)
    assert g.num_nodes == v
    assert np.array_equal(np.asarray(g.src), src) and np.array_equal(np.asarray(g.dst), dst)
    again = load_graph(path, chunk_edges=500)
    assert again.source == "cache" and again.stats.bytes_parsed == 0


@pytest.mark.parametrize("where", ["data-dir", "cache-only", "synthetic"])
def test_resolution_order_as_the_reference(tmp_path, monkeypatch, where):
    """Real file under $SSUMM_DATA_DIR, then a cache under $SSUMM_CACHE_DIR,
    then the synthetic stand-in: the same source label from both packages."""
    data, cache = os.path.join(tmp_path, "data"), os.path.join(tmp_path, "cache")
    os.makedirs(data)
    os.makedirs(cache)
    monkeypatch.setenv(pio.CACHE_DIR_ENV, cache)
    name = "ego-facebook"
    if where != "synthetic":
        src, dst, v = _edges(seed=4)
        path = rio.write_edge_list(os.path.join(data, name + ".txt"), src, dst, v)
        rio.load_graph(path)  # its cache lands under $SSUMM_CACHE_DIR
    if where == "cache-only":
        os.remove(path)
    else:
        monkeypatch.setenv(pio.DATA_DIR_ENV, data)
    got = pio.load_graph(name, scale=0.02, seed=1)
    want = rio.load_graph(name, scale=0.02, seed=1)
    assert got.source == {"data-dir": "cache", "cache-only": "cache",
                          "synthetic": "synthetic"}[where]
    _same_graph(got, want)


def test_launcher_reads_an_edge_list(tmp_path, capsys):
    src, dst, v = generate("ego-facebook", seed=0, scale=0.03)
    path = write_edge_list(os.path.join(tmp_path, "fb.txt"), src, dst, v, shuffle=True)
    args = ["--edge-list", path, "--T", "2", "--device", "cpu"]
    first = launch.main(args + ["--chunk-edges", "100"])
    digests, body = capsys.readouterr().out.split("\n", 1)
    assert digests.startswith("digests node2super=")
    assert json.loads(body) == json.loads(json.dumps(first))
    assert first["dataset"] == path and first["source"] == "real"
    assert first["V"] == v and first["E"] == len(src)
    assert first["ingest_bytes_parsed"] == os.path.getsize(path)
    assert first["ingest_chunks"] > 1 and first["load_wall_s"] >= 0
    second = launch.main(args)
    assert second["source"] == "cache" and second["ingest_bytes_parsed"] == 0
    assert second["num_supernodes"] == first["num_supernodes"]
    third = launch.main(args + ["--reingest"])
    assert third["source"] == "real" and third["size_bits"] == first["size_bits"]


def test_a_corrupt_cache_read_raises_instead_of_giving_another_graph(tmp_path):
    """A cache's edges are canonical as written; read back out of order (a
    span of ``src`` zeroed, as a short read would leave it) they raise."""
    src, dst, v = generate("ego-facebook", seed=0, scale=0.05)
    path = str(tmp_path / "g.txt")
    write_edge_list(path, src, dst, v)
    g = load_graph(path)
    got_src, got_dst = g.edges()
    assert np.array_equal(got_src, src) and np.array_equal(got_dst, dst)
    assert pio.is_canonical(got_src, got_dst)
    member = np.load(os.path.join(g.cache_dir, "src.npy"), mmap_mode="r+")
    member[len(src) // 2:len(src) // 2 + 8] = 0
    member.flush()
    del member
    again = load_graph(path)
    assert again.source == "cache"  # whole on disk: the freshness check passes
    with pytest.raises(OSError, match="corrupt read"):
        again.edges()


def test_canonical_edges_skip_the_sort_with_the_same_graph():
    from repro_torch.core.types import make_graph

    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 300, (2, 4000))
    noisy = make_graph(a, b, 300, "cpu")[0]
    src, dst = noisy.src.numpy(), noisy.dst.numpy()
    assert pio.is_canonical(src, dst) and not pio.is_canonical(a, b)
    again = make_graph(src, dst, 300, "cpu")[0]
    assert torch.equal(again.src, noisy.src) and torch.equal(again.dst, noisy.dst)
    assert not pio.is_canonical(src[::-1], dst[::-1])  # out of order
    assert not pio.is_canonical(np.r_[src[:1], src], np.r_[dst[:1], dst])  # a pair twice
    assert not pio.is_canonical(dst, src)  # src > dst
