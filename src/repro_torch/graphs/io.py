"""Streaming edge-list ingestion: SNAP text → binary CSR cache → mmap load.

Own copy of ``repro/graphs/io.py`` (the port imports nothing of ``repro``),
host numpy code kept as it is there: the same parser, the same external
sort, the same cache format byte for byte (``CACHE_VERSION``, the four
``.npy`` members, ``meta.json``), so a cache written by either package
loads in the other, and the same environment names (``SSUMM_DATA_DIR``,
``SSUMM_CACHE_DIR``, ``SSUMM_CHUNK_EDGES``).

The reader takes SNAP-format text (``.txt``/``.csv``, ``#``/``%``
comments, optional gzip) in fixed-size chunks, canonicalizes each chunk
(undirected ``lo < hi``, self-loops stripped), spills sorted unique runs to
disk, and k-way block-merges the runs into a deduplicated canonical edge
list — peak RSS is bounded by the chunk size (plus an O(|V|) id table),
never by |E|. The result is materialized once as a binary cache directory
of ``.npy`` files (canonical edge arrays + a symmetrized CSR) that later
loads open with ``np.load(..., mmap_mode="r")`` in O(1).

Node-id relabeling is deterministic: ids are mapped to a dense contiguous
range by *sorted original id*, so a file whose ids are already
``0..V-1``-dense loads with identity labels — this is what makes the
``--edge-list`` path bit-identical to the in-memory ``generate`` path on
the same edge set. A SNAP ``# Nodes: <n> Edges: <m>`` header is honored:
when every observed id is ``< n`` the loader keeps original labels and
``num_nodes = n`` (preserving isolated nodes, which edge lists cannot
otherwise express); ids outside the header range fall back to relabeling.

Dataset resolution order (``load_graph``): real file under
``$SSUMM_DATA_DIR`` → binary cache → synthetic stand-in (``generate``).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import re
import shutil
import tempfile

import numpy as np

from repro_torch.graphs import synthetic

DATA_DIR_ENV = "SSUMM_DATA_DIR"
CACHE_DIR_ENV = "SSUMM_CACHE_DIR"
CHUNK_EDGES_ENV = "SSUMM_CHUNK_EDGES"

CACHE_SUFFIX = ".ssummcache"
CACHE_VERSION = 1
# every member a fresh cache must carry; a cache that lost one (e.g. a
# mid-write crash between the staging swap and a later manual cleanup)
# is treated as absent and re-ingested rather than raising downstream
CACHE_MEMBERS = ("src.npy", "dst.npy", "indptr.npy", "indices.npy")
DEFAULT_CHUNK_EDGES = 1 << 20
_EXTS = (".txt", ".txt.gz", ".csv", ".csv.gz", ".el", ".el.gz")
# raw ids pack two-per-*signed*-int64 during the merge and land in int32
# arrays after relabeling, so the raw-id ceiling is 2^31 (covers every
# SNAP dataset in Table 2; web-uk-05 has |V| ≈ 39M)
_ID_LIMIT = 1 << 31

_HEADER_RE = re.compile(r"Nodes:\s*(\d+)")


@dataclasses.dataclass
class IngestStats:
    """Parser-side accounting (``bytes_parsed == 0`` ⇔ pure cache hit)."""

    bytes_parsed: int = 0
    lines_parsed: int = 0
    comment_lines: int = 0
    edges_raw: int = 0
    self_loops_dropped: int = 0
    duplicates_dropped: int = 0
    chunks: int = 0
    max_chunk_rows: int = 0
    spill_runs: int = 0
    relabeled: bool = False
    header_nodes: int | None = None

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LoadedGraph:
    """A canonical graph plus where it came from (``real|cache|synthetic``)."""

    src: np.ndarray  # int32[E], src < dst, unique, sorted by (src, dst)
    dst: np.ndarray  # int32[E]
    num_nodes: int
    source: str
    path: str | None  # source text file (real) or None
    cache_dir: str | None
    stats: IngestStats

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """``src``/``dst`` read into memory, once. A cache's edges are
        canonical as written (:func:`is_canonical`), so edges read back from
        one that are not are a corrupt read: it raises instead of handing a
        different graph on."""
        src, dst = np.array(self.src), np.array(self.dst)
        if self.cache_dir is not None and not is_canonical(src, dst):
            raise OSError(f"{self.cache_dir!r}: the edges read back from the cache are not "
                          f"sorted, unique and src < dst ({src.shape[0]} rows): a corrupt read")
        return src, dst


def is_canonical(src, dst) -> bool:
    """True iff the edge list is canonical as a cache holds it: sorted by
    ``(src, dst)``, no pair twice, ``src < dst``."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if not bool(np.all(src < dst)):
        return False
    s0, s1 = src[:-1], src[1:]
    return bool(np.all((s1 > s0) | ((s1 == s0) & (dst[1:] > dst[:-1]))))


# ---------------------------------------------------------------------------
# Chunked text parsing
# ---------------------------------------------------------------------------


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8", errors="replace")
    return open(path, "rt", encoding="utf-8", errors="replace")


def iter_edge_chunks(path: str, chunk_edges: int, stats: IngestStats):
    """Yield ``(src, dst)`` int64 chunk arrays of ≲ ``chunk_edges`` rows.

    Comment lines (``#``/``%``) are counted and skipped; a SNAP
    ``# Nodes: <n>`` header is recorded in ``stats.header_nodes``. Commas
    are treated as whitespace so ``.csv`` parses identically; rows with
    extra columns (weights, timestamps) keep their first two fields.
    """
    sizehint = max(chunk_edges, 1) * 24  # ~bytes per SNAP line
    with _open_text(path) as f:
        while True:
            lines = f.readlines(sizehint)
            if not lines:
                return
            stats.bytes_parsed += sum(len(ln) for ln in lines)
            stats.lines_parsed += len(lines)
            data = []
            for ln in lines:
                s = ln.strip()
                if not s:
                    continue
                if s[0] in "#%":
                    stats.comment_lines += 1
                    if stats.header_nodes is None:
                        m = _HEADER_RE.search(s)
                        if m:
                            stats.header_nodes = int(m.group(1))
                    continue
                data.append(s.replace(",", " "))
            if not data:
                continue
            # split per line (an aggregate token count can silently mispair
            # fields across rows with mixed column counts); rows with extra
            # columns — weights, timestamps — keep their first two fields
            pairs = [ln.split(None, 3) for ln in data]
            bad = next((p for p in pairs if len(p) < 2), None)
            if bad is not None:
                raise ValueError(f"{path}: malformed edge line {bad!r} "
                                 f"(need two node ids)")
            arr = np.array([p[:2] for p in pairs], dtype=np.int64)
            if arr.size and (arr.min() < 0 or arr.max() >= _ID_LIMIT):
                raise ValueError(
                    f"{path}: node ids must be in [0, 2^31); "
                    f"got range [{arr.min()}, {arr.max()}]")
            stats.edges_raw += arr.shape[0]
            stats.chunks += 1
            stats.max_chunk_rows = max(stats.max_chunk_rows, arr.shape[0])
            yield arr[:, 0], arr[:, 1]


# ---------------------------------------------------------------------------
# External merge of sorted unique runs (bounded memory)
# ---------------------------------------------------------------------------


def _spill_runs(path: str, chunk_edges: int, workdir: str,
                stats: IngestStats) -> list[str]:
    """Canonicalize each chunk and spill it as a sorted unique key run."""
    runs = []
    for src, dst in iter_edge_chunks(path, chunk_edges, stats):
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        keep = lo != hi
        stats.self_loops_dropped += int((~keep).sum())
        keys = np.unique((lo[keep] << np.int64(32)) | hi[keep])
        stats.duplicates_dropped += int(keep.sum()) - keys.size
        if keys.size == 0:
            continue
        run = os.path.join(workdir, f"run{len(runs):05d}.npy")
        np.save(run, keys)
        runs.append(run)
    stats.spill_runs = len(runs)
    return runs


def _merge_runs(runs: list[str], out_path: str, block: int) -> int:
    """K-way block-merge the sorted runs into ``out_path`` (raw int64),
    dropping cross-run duplicates. Returns the number of unique keys.

    Per round: every active run exposes its next ≤``block`` keys; the
    cut is the smallest block-end value, so each run's block provably
    contains *all* of its keys ≤ cut — those prefixes merge with one
    concatenate+unique of ≤ ``len(runs)·block`` elements.
    """
    mms = [np.load(r, mmap_mode="r") for r in runs]
    pos = [0] * len(mms)
    total = 0
    prev_last: int | None = None
    with open(out_path, "wb") as out:
        while True:
            ends = [
                mm[min(p + block, len(mm)) - 1]
                for mm, p in zip(mms, pos) if p < len(mm)
            ]
            if not ends:
                break
            cut = min(ends)
            parts = []
            for i, mm in enumerate(mms):
                if pos[i] >= len(mm):
                    continue
                blk = mm[pos[i]:pos[i] + block]
                take = int(np.searchsorted(blk, cut, side="right"))
                if take:
                    parts.append(np.asarray(blk[:take]))
                    pos[i] += take
            merged = np.unique(np.concatenate(parts))
            if prev_last is not None and merged.size and merged[0] == prev_last:
                merged = merged[1:]  # boundary duplicate across rounds
            if merged.size:
                prev_last = int(merged[-1])
                merged.tofile(out)
                total += merged.size
    return total


# ---------------------------------------------------------------------------
# Cache materialization (canonical edges + symmetrized CSR)
# ---------------------------------------------------------------------------


def _file_stamp(path: str) -> dict:
    st = os.stat(path)
    return {"size": st.st_size, "mtime_ns": st.st_mtime_ns,
            "name": os.path.basename(path)}


def _blocks(n: int, block: int):
    for start in range(0, n, block):
        yield start, min(start + block, n)


def _write_cache(keys_path: str, n_edges: int, cache_dir: str,
                 source_path: str, chunk_edges: int,
                 stats: IngestStats) -> None:
    """Turn the merged key stream into the final ``.npy`` cache files."""
    block = max(chunk_edges, 1024)
    keys = np.memmap(keys_path, dtype=np.int64, mode="r", shape=(n_edges,)) \
        if n_edges else np.zeros((0,), np.int64)

    # id table: header-identity when every id < header's |V|, else dense
    # relabel by sorted original id (deterministic, chunk-independent).
    # Per-block uniques accumulate and collapse only when the pending pile
    # outgrows the table (amortized doubling) — O(log) collapses instead
    # of one O(|V| log |V|) union per block.
    max_id = -1
    ids = np.zeros((0,), np.int64)
    pend: list[np.ndarray] = []
    pend_n = 0
    for a, b in _blocks(n_edges, block):
        k = np.asarray(keys[a:b])
        if not k.size:
            continue
        lo, hi = k >> np.int64(32), k & np.int64(0xFFFFFFFF)
        max_id = max(max_id, int(hi.max()), int(lo.max()))
        u = np.unique(np.concatenate([lo, hi]))
        pend.append(u)
        pend_n += u.size
        if pend_n >= max(ids.size, block):
            ids = np.union1d(ids, np.concatenate(pend))
            pend, pend_n = [], 0
    if pend:
        ids = np.union1d(ids, np.concatenate(pend))
        del pend
    header = stats.header_nodes
    if header is not None and max_id < min(header, 1 << 31):
        v, relabel = int(header), None
    elif n_edges == 0:
        v, relabel = (int(header) if header is not None else 0), None
    else:
        v, relabel = int(ids.size), ids
    stats.relabeled = relabel is not None

    # stage in a per-build private dir (concurrent ingests of the same
    # file must not clobber each other's half-written staging area)
    parent = os.path.dirname(os.path.abspath(cache_dir)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(cache_dir) + ".tmp",
                           dir=parent)
    try:
        _fill_cache_arrays(tmp, keys, n_edges, v, relabel, block)
        meta = {
            "version": CACHE_VERSION,
            "num_nodes": v,
            "num_edges": n_edges,
            "relabeled": relabel is not None,
            "source": _file_stamp(source_path),
            "stats": stats.asdict(),
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(cache_dir, ignore_errors=True)
    try:
        os.replace(tmp, cache_dir)
    except OSError:
        # a concurrent build of the same file won the swap; its cache is
        # byte-identical (the build is deterministic), so keep it
        shutil.rmtree(tmp, ignore_errors=True)


def _fill_cache_arrays(tmp: str, keys, n_edges: int, v: int,
                       relabel, block: int) -> None:
    """Write src/dst/indptr/indices ``.npy`` into ``tmp`` in row-aligned
    blocks (all memmap-backed; nothing O(|E|) in memory)."""
    src_mm = np.lib.format.open_memmap(
        os.path.join(tmp, "src.npy"), mode="w+", dtype=np.int32,
        shape=(n_edges,))
    dst_mm = np.lib.format.open_memmap(
        os.path.join(tmp, "dst.npy"), mode="w+", dtype=np.int32,
        shape=(n_edges,))
    deg = np.zeros((v,), np.int64)
    for a, b in _blocks(n_edges, block):
        k = np.asarray(keys[a:b])
        lo, hi = k >> np.int64(32), k & np.int64(0xFFFFFFFF)
        if relabel is not None:
            lo = np.searchsorted(relabel, lo)
            hi = np.searchsorted(relabel, hi)
        src_mm[a:b] = lo.astype(np.int32)
        dst_mm[a:b] = hi.astype(np.int32)
        deg += np.bincount(lo, minlength=v) + np.bincount(hi, minlength=v)

    indptr = np.zeros((v + 1,), np.int64)
    np.cumsum(deg, out=indptr[1:])
    np.save(os.path.join(tmp, "indptr.npy"), indptr)
    indices = np.lib.format.open_memmap(
        os.path.join(tmp, "indices.npy"), mode="w+", dtype=np.int32,
        shape=(2 * n_edges,))
    next_free = indptr[:-1].copy()
    for a, b in _blocks(n_edges, block):
        rows = np.concatenate([src_mm[a:b], dst_mm[a:b]]).astype(np.int64)
        cols = np.concatenate([dst_mm[a:b], src_mm[a:b]])
        order = np.argsort(rows, kind="stable")
        r, c = rows[order], cols[order]
        uniq, first, counts = np.unique(r, return_index=True,
                                        return_counts=True)
        offs = np.arange(r.size, dtype=np.int64) - np.repeat(first, counts)
        indices[np.repeat(next_free[uniq], counts) + offs] = c
        next_free[uniq] += counts
    # sort neighbors within each row (bounded-memory pass over row-aligned
    # segments) — also makes the cache independent of the chunk size, which
    # would otherwise leak into the lo-side/hi-side interleaving order
    start_row = 0
    while start_row < v:
        end_row = int(np.searchsorted(indptr, indptr[start_row] + 2 * block,
                                      side="left"))
        end_row = min(max(end_row, start_row + 1), v)
        s, e = int(indptr[start_row]), int(indptr[end_row])
        if e > s:
            seg = np.asarray(indices[s:e], np.int64)
            rows = np.repeat(
                np.arange(start_row, end_row, dtype=np.int64),
                np.diff(indptr[start_row:end_row + 1]))
            order = np.argsort(rows * v + seg, kind="stable")
            indices[s:e] = seg[order].astype(np.int32)
        start_row = end_row
    src_mm.flush(); dst_mm.flush(); indices.flush()
    del src_mm, dst_mm, indices


def default_cache_dir(path: str) -> str:
    root = os.environ.get(CACHE_DIR_ENV)
    if root:
        return os.path.join(root, os.path.basename(path) + CACHE_SUFFIX)
    return path + CACHE_SUFFIX


def _chunk_edges_default(chunk_edges: int | None) -> int:
    if chunk_edges is not None:
        return int(chunk_edges)
    return int(os.environ.get(CHUNK_EDGES_ENV, DEFAULT_CHUNK_EDGES))


def ingest_edge_list(path: str, cache_dir: str | None = None,
                     chunk_edges: int | None = None) -> str:
    """Parse ``path`` once and materialize its binary cache; returns the
    cache directory. Peak memory ~ O(chunk_edges + |V|), never O(|E|)."""
    cache_dir = cache_dir or default_cache_dir(path)
    chunk_edges = _chunk_edges_default(chunk_edges)
    stats = IngestStats()
    workdir = tempfile.mkdtemp(prefix="ssumm-ingest-")
    try:
        runs = _spill_runs(path, chunk_edges, workdir, stats)
        keys_path = os.path.join(workdir, "merged.keys")
        if len(runs) == 1:
            # single run: already sorted unique — link it in place
            np.load(runs[0], mmap_mode="r")[:].tofile(keys_path)
            n = np.load(runs[0], mmap_mode="r").shape[0]
        elif runs:
            # split the chunk budget across runs so the per-round concat
            # stays ≤ ~chunk_edges elements regardless of run count
            n = _merge_runs(runs, keys_path,
                            block=max(chunk_edges // len(runs), 1024))
        else:
            open(keys_path, "wb").close()
            n = 0
        # duplicates dropped across chunks = spilled total − merged total
        spilled = sum(np.load(r, mmap_mode="r").shape[0] for r in runs)
        stats.duplicates_dropped += spilled - n
        _write_cache(keys_path, n, cache_dir, path, chunk_edges, stats)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return cache_dir


def _member_is_intact(path: str, dtype: np.dtype, shape: tuple) -> bool:
    """True iff ``path`` is a complete ``.npy`` of exactly dtype/shape.

    Reads only the npy header (a few hundred bytes), then checks the file
    size equals header + payload — a blob truncated by a crashed or killed
    writer is caught here without paging in any data."""
    readers = {(1, 0): np.lib.format.read_array_header_1_0,
               (2, 0): np.lib.format.read_array_header_2_0}
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            reader = readers.get(tuple(version))
            if reader is None:
                return False
            got_shape, fortran, got_dtype = reader(f)
            data_start = f.tell()
    except (OSError, ValueError):
        return False
    if fortran or got_dtype != dtype or tuple(got_shape) != tuple(shape):
        return False
    expect = data_start + int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return os.path.getsize(path) == expect


def _expected_members(meta: dict) -> dict[str, tuple[np.dtype, tuple]]:
    """dtype/shape of every cache member, derived from meta.json counts."""
    v, e = int(meta["num_nodes"]), int(meta["num_edges"])
    return {
        "src.npy": (np.dtype(np.int32), (e,)),
        "dst.npy": (np.dtype(np.int32), (e,)),
        "indptr.npy": (np.dtype(np.int64), (v + 1,)),
        "indices.npy": (np.dtype(np.int32), (2 * e,)),
    }


def cache_is_fresh(cache_dir: str, source_path: str | None = None) -> bool:
    """A cache is fresh iff meta.json parses, matches the source stamp,
    and **all four** ``.npy`` members are intact — present, with the
    dtype/shape meta.json implies, and byte-complete on disk. A directory
    that lost a member or holds a truncated blob (mid-write crash, partial
    copy, disk-full) must fall through to re-ingestion instead of raising
    (or worse, mmap-ing zeros) at ``np.load`` time."""
    meta_path = os.path.join(cache_dir, "meta.json")
    if not os.path.exists(meta_path):
        return False
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    if meta.get("version") != CACHE_VERSION:
        return False
    try:
        expected = _expected_members(meta)
    except (KeyError, TypeError, ValueError):
        return False
    assert set(expected) == set(CACHE_MEMBERS)
    for member, (dtype, shape) in expected.items():
        if not _member_is_intact(os.path.join(cache_dir, member),
                                 dtype, shape):
            return False
    if source_path is not None and os.path.exists(source_path):
        if meta.get("source") != _file_stamp(source_path):
            return False
    return True


def load_cache(cache_dir: str, source: str = "cache",
               path: str | None = None) -> LoadedGraph:
    """O(1) load: ``.npy`` arrays open with ``mmap_mode="r"``, 0 bytes
    of text are parsed (``stats.bytes_parsed == 0``)."""
    with open(os.path.join(cache_dir, "meta.json")) as f:
        meta = json.load(f)
    stats = IngestStats(relabeled=bool(meta.get("relabeled", False)),
                        header_nodes=meta.get("stats", {}).get("header_nodes"))
    return LoadedGraph(
        src=np.load(os.path.join(cache_dir, "src.npy"), mmap_mode="r"),
        dst=np.load(os.path.join(cache_dir, "dst.npy"), mmap_mode="r"),
        num_nodes=int(meta["num_nodes"]),
        source=source, path=path, cache_dir=cache_dir, stats=stats,
    )


def open_csr(cache_dir: str) -> tuple[np.ndarray, np.ndarray]:
    """The symmetrized CSR adjacency (``indptr`` int64[V+1], ``indices``
    int32[2E], mmap'd; neighbors sorted ascending within each row)."""
    return (np.load(os.path.join(cache_dir, "indptr.npy"), mmap_mode="r"),
            np.load(os.path.join(cache_dir, "indices.npy"), mmap_mode="r"))


# ---------------------------------------------------------------------------
# Registry resolution: real file → cache → synthetic
# ---------------------------------------------------------------------------


def find_real_file(name: str, data_dir: str | None = None) -> str | None:
    data_dir = data_dir or os.environ.get(DATA_DIR_ENV)
    if not data_dir:
        return None
    for ext in _EXTS:
        p = os.path.join(data_dir, name + ext)
        if os.path.exists(p):
            return p
    return None


def load_graph(name_or_path: str, *, data_dir: str | None = None,
               cache_dir: str | None = None, chunk_edges: int | None = None,
               refresh: bool = False, scale: float = 1.0,
               seed: int = 0) -> LoadedGraph:
    """Resolve a Table-2 name or an explicit edge-list path to a graph.

    Priority: real file (``$SSUMM_DATA_DIR`` or the path itself) → its
    binary cache (if fresh; re-ingested otherwise) → synthetic stand-in
    (registry names only; ``scale``/``seed`` apply there and only there).
    ``refresh=True`` forces a re-parse even when the cache is fresh.
    """
    path = name_or_path if os.path.exists(name_or_path) else \
        find_real_file(name_or_path, data_dir)
    if path is not None:
        cdir = cache_dir or default_cache_dir(path)
        if refresh or not cache_is_fresh(cdir, path):
            cdir = ingest_edge_list(path, cdir, chunk_edges)
            g = load_cache(cdir, source="real", path=path)
            # surface the parse-side accounting of the ingest we just did
            with open(os.path.join(cdir, "meta.json")) as f:
                g.stats = IngestStats(**json.load(f)["stats"])
            return g
        return load_cache(cdir, source="cache", path=path)
    # no source file: a cache built earlier may still serve the name.
    # Ingest names caches `<basename-with-extension>.ssummcache`, so probe
    # every extension variant under $SSUMM_CACHE_DIR and the data dir.
    roots = [r for r in (os.environ.get(CACHE_DIR_ENV),
                         data_dir or os.environ.get(DATA_DIR_ENV)) if r]
    candidates = [cache_dir] if cache_dir else [
        os.path.join(root, name_or_path + ext + CACHE_SUFFIX)
        for root in roots for ext in ("",) + _EXTS]
    for cdir in candidates:
        if cache_is_fresh(cdir):
            return load_cache(cdir)
    if name_or_path in synthetic.DATASETS:
        src, dst, v = synthetic.generate(name_or_path, seed=seed, scale=scale)
        return LoadedGraph(src=np.asarray(src, np.int32),
                           dst=np.asarray(dst, np.int32), num_nodes=v,
                           source="synthetic", path=None, cache_dir=None,
                           stats=IngestStats())
    raise FileNotFoundError(
        f"{name_or_path!r}: not a file, not under ${DATA_DIR_ENV}, no cache, "
        f"and not a registry dataset ({', '.join(sorted(synthetic.DATASETS))})")


# ---------------------------------------------------------------------------
# Deterministic SNAP-text writer (test fixtures, chip_smoke.py)
# ---------------------------------------------------------------------------


def write_edge_list(path: str, src, dst, num_nodes: int, *,
                    seed: int = 0, shuffle: bool = False,
                    one_indexed: bool = False, dup_frac: float = 0.0,
                    self_loops: int = 0, header: bool = True,
                    comment: str | None = None,
                    block_lines: int = 1 << 16) -> str:
    """Emit an edge list as SNAP text (gzip when ``path`` ends in ``.gz``,
    comma-separated when it contains ``.csv``). Deterministic in ``seed``.

    ``shuffle`` permutes edge order and flips random edge directions;
    ``dup_frac`` re-appends that fraction of edges; ``self_loops`` appends
    loops — all noise the streaming loader must normalize away.
    """
    rng = np.random.default_rng(seed)
    src = np.asarray(src, np.int64).copy()
    dst = np.asarray(dst, np.int64).copy()
    if dup_frac > 0.0 and src.size:
        n_dup = int(src.size * dup_frac)
        idx = rng.integers(0, src.size, n_dup)
        src = np.concatenate([src, src[idx]])
        dst = np.concatenate([dst, dst[idx]])
    if self_loops > 0:
        loops = rng.integers(0, max(num_nodes, 1), self_loops)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    if shuffle and src.size:
        perm = rng.permutation(src.size)
        src, dst = src[perm], dst[perm]
        flip = rng.random(src.size) < 0.5
        src, dst = np.where(flip, dst, src), np.where(flip, src, dst)
    if one_indexed:
        src, dst = src + 1, dst + 1
    sep = "," if ".csv" in os.path.basename(path) else "\t"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        if comment:
            f.write(f"# {comment}\n")
        if header:
            f.write(f"# Nodes: {num_nodes} Edges: {src.size}\n")
        for a, b in _blocks(int(src.size), block_lines):
            f.write("\n".join(
                f"{s}{sep}{d}" for s, d in zip(src[a:b], dst[a:b])) + "\n")
    return path
