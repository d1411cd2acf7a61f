"""Core data structures: graphs, summary state, pair tables, config, result.

Port of ``repro/core/types.py``. Every table keeps the reference's fixed
capacity (``V`` supernode ids, ``E`` pair rows) and masks live rows, so a
round runs without the host learning any data-dependent size. Supernode ids
live in ``[0, V)``; dead ids have ``size == 0``. Ids are int64 inside the
port (torch indexes with int64); :class:`SummaryResult` returns int32 like
the reference.

``SummaryState`` holds no random key: each round draws its permutations from
an explicit source (:mod:`repro_torch.core.shingles`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """The run's device; a CUDA request without a card raises.

    Entry points default to ``"cuda"`` and never carry on quietly on the CPU:
    the CPU runs only when the caller passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch was asked to run on CUDA, but torch.cuda.is_available() "
            "is False (no card, or a CPU-only PyTorch). Pass device='cpu' "
            "(--device cpu) to run the plain versions on the CPU.")
    return dev


@dataclasses.dataclass
class Graph:
    """Canonical undirected simple graph: ``src < dst``, no self-loops, unique."""

    src: torch.Tensor  # int64[E]
    dst: torch.Tensor  # int64[E]

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass
class SummaryState:
    """State of the summarization search.

    ``node2super[v]`` maps every subnode to its supernode id; ``size[a]`` is
    the number of subnodes in supernode ``a`` (0 = dead id); ``t`` is the
    1-based round counter.
    """

    node2super: torch.Tensor  # int64[V]
    size: torch.Tensor  # int64[V]
    t: int


@dataclasses.dataclass
class PairTable:
    """Supernode-pair table aggregated from the edge list.

    Capacity ``E`` rows; ``valid`` masks live rows; self pairs have
    ``lo == hi``. ``cnt`` holds exact integers in float32.
    """

    lo: torch.Tensor  # int64[E]
    hi: torch.Tensor  # int64[E]
    cnt: torch.Tensor  # float32[E]
    valid: torch.Tensor  # bool[E]

    @property
    def capacity(self) -> int:
        return int(self.lo.shape[0])


KERNEL_BACKENDS = (None, "ref", "kernel")


@dataclasses.dataclass(frozen=True)
class SummaryConfig:
    """Hyper-parameters of the search; the same fields as the reference's.

    ``kernel_backend`` picks the merge-gain and pair-cost implementation:
    ``None`` takes the hand kernel on a CUDA tensor and the plain PyTorch
    version on a CPU tensor; ``"ref"`` always takes the plain version;
    ``"kernel"`` always takes the hand kernel (and raises on CPU tensors).
    There is no environment variable.
    """

    T: int = 20  # outer iterations (paper default, Fig. 8)
    k_frac: float | None = None  # target size as a fraction of Size(G)
    k_bits: float | None = None  # absolute target size in bits
    group_size: int = 32  # C_max — candidate-set cap (paper: 500)
    max_neighbors: int = 64  # D_max — per-supernode scored-neighbor cap
    union_size: int = 128  # U_max — per-group union-neighbor columns
    cbar_mode: str = "tight"  # "paper": 2log2|V|+log2|E|; "tight": footnote 3
    re_guard: int = 1  # 0 = off; p in {1,2}: never keep superedges that raise RE_p
    error_p: int = 1  # p for the final sparsification deltas (footnote 4)
    ensure_budget: bool = True  # extra θ=0 iterations if membership term > k
    max_extra_iters: int = 40
    kernel_backend: str | None = None
    # R — rounds per engine chunk; the host reads each round's scalars once,
    # and a chunk ends early on the device-side stopping test (f32 compare).
    driver_chunk: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"unknown kernel_backend {self.kernel_backend!r}; valid: "
                f"{list(KERNEL_BACKENDS)}")

    def target_bits(self, size_g: float) -> float:
        if self.k_bits is not None:
            return float(self.k_bits)
        if self.k_frac is not None:
            return float(self.k_frac) * float(size_g)
        return 0.3 * float(size_g)


@dataclasses.dataclass
class SummaryResult:
    """Final output: the summary graph Ḡ = (S, P, ω) plus evaluation stats."""

    node2super: np.ndarray  # int32[V]
    super_size: np.ndarray  # int32[V]
    edge_lo: np.ndarray  # int32[P] superedge endpoints (supernode ids)
    edge_hi: np.ndarray  # int32[P]
    edge_w: np.ndarray  # int64[P] ω
    num_supernodes: int
    num_superedges: int
    size_bits: float  # Eq. (4)
    input_size_bits: float  # Eq. (3)
    re1: float  # normalized ℓ1 reconstruction error
    re2: float  # normalized ℓ2 reconstruction error
    mdl_cost: float  # Eq. (14)
    iterations_run: int
    history: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    chunk_wall_s: list = dataclasses.field(default_factory=list)


def make_graph(src, dst, num_nodes: int,
               device: str | torch.device = "cuda") -> tuple[Graph, int]:
    """Canonicalize an edge list (undirected, dedup, no self-loops, src<dst)
    on the host and place it on ``device``."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    key = lo * int(num_nodes) + hi
    _, idx = np.unique(key, return_index=True)
    dev = resolve_device(device)
    g = Graph(src=torch.as_tensor(lo[idx], device=dev),
              dst=torch.as_tensor(hi[idx], device=dev))
    return g, int(num_nodes)


def init_state(num_nodes: int, device: str | torch.device = "cuda") -> SummaryState:
    """Ḡ := G (Alg. 1 lines 1–2): every subnode is its own supernode."""
    dev = resolve_device(device)
    return SummaryState(
        node2super=torch.arange(num_nodes, dtype=torch.int64, device=dev),
        size=torch.ones(num_nodes, dtype=torch.int64, device=dev),
        t=1,
    )
