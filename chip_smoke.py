#!/usr/bin/env python3
"""Smoke test of repro_torch (the PyTorch port of SSumM) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand kernels from this checkout's sources, holds each against
its plain PyTorch version (the merge gain's and the segment sum's on CPU
copies of the card's operands, where they add as the reference does; the
pair cost's on the card), drives the port's two paths on the skitter
stand-in with the default config — summarization
(``repro_torch.core.summarize``) at full size (V = 2,097,152, E =
11,095,298) and query serving from an edge-list file of a quarter of it
(``repro_torch.launch.query_serve``) — and compares
card and CPU runs. Phases, one line each or a few:

  1. device: the card's name and power limit, CUDA, the kernels' build time;
  2. merge_gain (CUDA) against plain, on CPU copies and on the card (the
     plain version adds over U in the reference's order on both): test
     shapes, C=64/U=256 (shared-memory opt-in), every group of the real
     round-1 tables on the card, an eighth of them and the 512 densest on
     CPU copies; the dense case's time; argmax tie rules;
  3. pair_cost (Triton) against plain: E in {7, 1025, 5000} and the real
     pair table;
  4. the main path at full size: budget met, metrics finite, each kernel
     launched once per round; then one round replayed stage by stage, and
     once under torch.profiler, to show where its time goes;
  4c. determinism: a second full-size run equal to phase 4's bit for bit
     (``node2super``, ``super_size``, ``edge_w``, the integer history); the
     exact total costs against the ``index_add_`` pair they replaced, on the
     pair tables of round 1 and of the final partition;
  5. card against CPU on the golden fixture, with the same permutations;
  6. edge-list input: the stand-in at a quarter of its size (V = 524,288,
     E = 2,773,824; the full size's write and parse took 79.4 s) written as
     SNAP text with noise, read back through ``load_graph`` (identical to
     ``generate``), then a cache hit; phases 7-11 read this file;
  7. query serving end to end: ``query_serve.main`` on that file, 4096
     requests of all seven kinds in 64 slots; each kernel of the path
     launched (the summarizer's once per round);
  7b. queries, card against CPU: engines on phase 4's summary serve one
     workload, the card's all 4096 requests twice (equal digests), the CPU's
     its first 1024; those answers agree at the port's test tolerances,
     equal PageRank steps; the block summary's sizes;
  7c. the fixed-order sums (CUDA): segment_sum against plain and numpy on
     test shapes, rows around the warp threshold and the block CSR of phase
     7b; ordered_sum against plain on empty and ragged rows and the query
     path's five shapes; each timed beside a PyTorch call, with the card's
     dependent float64 add latency and each shape's two-term bound;
  7d. where a serving step's time goes: engine build, PageRank, triangles,
     a 64-slot batch of each kind alone; eight steps under torch.profiler;
  8. checkpoint and resume through the launcher (``repro_torch.launch.chaos``)
     on phase 6's file: a golden run (equal to phase 4's config run in this
     process on that file's graph), a run SIGTERM'd once step 6 is
     committed (exit 75) and one SIGKILL'd at step 12, each resumed with
     ``--checkpoint-every 1``, equal to the golden on every exact key and
     digest, with each kernel launched once per resumed round; the resumed
     runs' bytes a step, snapshot and write times (the uninterrupted
     checkpointed run was cut for the script's time limit);
  9. edge-sharded: the launcher's ``--distributed`` on phase 6's file at a
     world of one over NCCL, twice (the same digests, exact keys and
     per-round stats), no bucket overflow, the budget met, the size
     shrinking, each kernel launched once a round; both kernels held against
     their plain versions on round 1's compact tables (the merge gain's and
     the pair cost's new call sites); a small case on the card against 2
     gloo ranks on the CPU;
  10. the multi-rank query tiers: the launcher's ``--distributed --tier
     replicated`` and ``--tier partitioned`` at a world of one over NCCL on
     phase 6's file with phase 7's stream, each giving phase 7's digest and
     launching each kernel of the path; on phase 4's summary the partition
     tables at P = 4 and 8 cover every rank's references, and both tiers
     with P = 4 ranks run one after another in this process equal the
     single-device engine bit for bit (PageRank blocks and steps, the
     triangle total, a 64-slot batch of each kind), each rank's resident row
     bytes below the whole CSR's; segment_sum over each rank's rows equals
     those rows of one launch over all;
  11. multi-host: (a) the launcher through the bootstrap's flags
     (``--coordinator localhost:PORT --num-processes 1 --process-id 0``) on
     phase 6's file, equal to phase 9's run on every exact key and digest,
     each kernel launched once a round, its median round beside phase 9's;
     (b) ``compressed_all_reduce`` on the card's tensors at a world of one
     over NCCL and with 4 ranks in this process, on the wire check's shapes
     and one 2^24-element float32 payload: measured wire bytes equal to the
     priced, sums equal to the CPU's float64 sums (rtol 1e-5), top-k
     conservation exact, each rank's residual its own; the encode and
     all-reduce times beside the payload's bytes bound; (c)
     ``tests/torch_multihost_check.py`` over 2 gloo processes on the host's
     CPU (ego-facebook 0.05, T = 5): golden, multihost, resume and wire legs,
     each leg's wall (host time);
  12. the baselines: (a) ``evaluate_partition`` of phase 4's partition on the
     card against the CPU (counts exact, floats to rtol 1e-12); (b) S2L on
     email-enron's stand-in at full size once on the card (wall, seeding,
     Lloyd iterations, peak memory, the chunk budget); (c) S2L
     at a quarter of it, card against CPU, each assignment recorded (labels
     equal, the first differing distance gap; RE1 and size within 1%), and
     a second card run equal to the first bit for bit; (d)
     the paper's Fig. 4 point: SSumM on the card against k-Gs and SAA-Gs
     (ego-facebook 0.1, seed 1, T = 10), each kernel launched once a round;
  13. LM serving: (a) qwen2.5-14B at full width, 2 layers, float32, TF32 off:
     forward on the card against the CPU, decode against forward (rtol and
     atol 1e-3); (b) 12 of the 48 layers at full width in bfloat16 (the
     depth cut for the time limit), initialised on the card from a seed, 8
     requests through ``BatchServer`` (8 slots, prompt 32, gen 32, max_len
     128) twice, the same tokens; init time, median decode step against its
     bytes bound, tokens/s, peak memory, three profiled steps;
  14. the MoE family's serving path (no hand kernel on it: the reference's
     MoE is plain jnp): (a) moonshot-v1-16b-a3b at full width, 2 layers,
     float32, TF32 off, capacity factor 16: forward on the card against the
     CPU, decode against forward (rtol and atol 1e-3), no record dropped on
     either side; (b) granite-moe-3b-a800m, 8 of its 32 bfloat16 layers (the
     depth cut for the time limit), 48 padded experts, initialised on the card from a seed, 8 requests through
     ``BatchServer`` as in 13b, twice, the same tokens; init time, median
     decode step against its bytes bound and against the bytes of the experts
     a steady step routes to, tokens/s, peak memory, three profiled steps,
     the hand kernels' launches on the path (none); (c) granite's MoE block
     at full width, float32, x [8, 128, 1536] at capacity factor 1.25
     (records dropped): two card runs bit-identical (the fixed-order
     combine), the drop fraction and the difference against CPU copies;
  15. the recurrent and image-prefix families (no hand kernel on them: the
     reference's Mamba2, xLSTM and image prefix are plain jnp): (a)
     zamba2-7b at full width, 6 layers (the shared attention block at
     i = 5), float32, TF32 off: forward on the card against the CPU, decode
     against forward (rtol and atol 1e-3), the forward at SSM chunk 8
     against one chunk of 16 (the carried state); (b) zamba2-7b, 14 of its
     81 layers in bfloat16 (the depth cut for the time limit; 2 shared-block
     sites), served as in 13b, twice, the same tokens; init time,
     median decode step against its bytes bound (parameters, the SSM and
     conv states read and written, the sites' KV caches), tokens/s, peak
     memory, three profiled steps, the hand kernels' launches (none); (c)
     xlstm-350m at full width and depth: float32 forward on the card against
     the CPU (1e-3), decode against forward (the reference's 2e-3); then in
     bfloat16 served as (b), the state (C, n, m, c, h) read and written in
     the bound; (d) paligemma-3b at full width, 2 float32 layers: the last
     position's logits with a [2, 256, 1152] image prefix and 16 text
     tokens, card against CPU (1e-3); all 18 bfloat16 layers: prefill_step
     on 8 x (256 image + 32 text) tokens, its median of 5 against the FLOP
     bound at 989 TFLOP/s, peak memory, its logits against the forward's
     last position, the hand kernels' launches (none);
  16. whisper-large-v3's encoder-decoder (no hand kernel on it: the
     reference's whisper is plain jnp): (a) at full width, 2 encoder + 2
     decoder layers, float32, TF32 off: the forward on the card against the
     CPU, and the decode step with the encoder's cross K/V in the cache
     (``whisper.fill_cross_cache``) against the forward, position by
     position (rtol and atol 1e-3); (b) 16 + 16 of its 32 + 32 bfloat16
     layers (the depth cut for the time limit): encode
     of 8 x 1500 frames, its median of 5 against the FLOP bound and one
     profiled call; the cross K/V projection; prefill_step; 8 requests
     through ``BatchServer`` as in 13b, twice, the same tokens (the cross
     K/V zero, as the reference serves whisper); median decode step against
     its bytes bound, peak memory, three profiled steps with the encoder's
     cross K/V in the cache, the hand kernels' launches (none);
  17. training (no hand kernel on it: the reference's loss, AdamW and
     accumulation are plain jnp): (a) h2o-danube-1.8b at full width, 2
     float32 layers, TF32 off: the loss and every gradient leaf on the card
     against the CPU, and one AdamW step on the same gradients; (b) all 24
     bfloat16 layers through ``repro_torch.launch.train`` at batch 8 x seq
     128 for 6 steps, twice: the same losses and final parameters bit for
     bit, the median step against the FLOP + AdamW-bytes bound, peak memory,
     one profiled step, the hand kernels' launches (none); (c) 2 bfloat16
     layers at full width, checkpoints at steps 3 and 6, the step-6 one
     removed and the run resumed from 3: equal bit for bit to the
     uninterrupted run; ``--compress int8``: the wire bytes equal to the
     priced;
  18. multi-rank training (no hand kernel on it: the reference's trainer,
     MoE dispatch and collectives are plain jnp and lax collectives), in an
     NCCL group of one (one card holds one NCCL rank): (a)
     ``repro_torch.launch.train`` at 17b's settings, equal to 17b's first run
     bit for bit, and ``--compress int8`` on 2 layers, its wire bytes 1 x the
     priced; (b) granite-moe-3b-a800m at full width: 2 float32 layers at
     capacity factor 1.25 (records drop), the loss and every gradient leaf
     on the card against the CPU; 8 of its 32 bfloat16 layers (the depth
     cut for the time limit) through the trainer at batch 8 x 128, 4 steps,
     twice, bit for bit: the drop fraction by layer, the median step against
     the FLOP + AdamW-bytes bound, peak memory; (c) granite's MoE block at
     full width, float32, x [8, 128, 1536]: ``apply_moe_a2a`` with EP = 4 in
     this process and over ``all_to_all_single`` in the group of one, against
     ``apply_moe_gspmd`` at capacity factor 8 (no drop; forward and the
     gradients of sum(y^2), rtol 2e-4, atol 2e-5), at 1.25 the drop
     fractions and two runs bit-identical, each path's forward + backward
     device time;
  19. tensor parallelism and FSDP's sharded storage (no hand kernel on it:
     the reference's sharding is GSPMD), in an NCCL group of one: (a)
     ``repro_torch.launch.train --want-model 2`` (danube at full width, 2
     bfloat16 layers, batch 8 x 128, 3 steps) plans (1, 1) and equals the
     ``--want-model 1`` run bit for bit; its ``stored_bytes_per_rank``;
     (b) each tensor-parallel layer's ranks at m = 2 and 4 in this process
     (``models/tp_ranks.py``: danube's MLP, head-parallel attention, the
     vocab-parallel embedding and loss; granite's MoE block expert-parallel
     over its 48 padded experts), float32, against the unsplit layer
     (forward and the gradients of sum(y^2), rtol 2e-4, atol 2e-5), with
     each one's forward + backward device time; (c) danube's full tree
     sharded by the (data 2, model 4) plan for each of its 8 ranks and put
     back together bit for bit, each rank's bytes against the table's;
  20. tensor-parallel compute of the other families (no hand kernel on it):
     (a) each new block's ranks at m = 2 and 4 in this process
     (``models/tp_ranks.py``: zamba2-7b's Mamba2 block over 2 chunks,
     xlstm-350m's mLSTM and sLSTM blocks, whisper-large-v3's encoder block at
     1500 frames and its decoder block with cross attention), float32,
     against the unsplit block within 19b's tolerance, with each one's
     forward + backward device time; (b) ``--want-model 2`` in an NCCL group
     of one equal to the ``--want-model 1`` run bit for bit, zamba2-7b (6
     bfloat16 layers) and xlstm-350m (4), batch 8 x 128, 3 steps; (c)
     zamba2-7b's full tree by the (data 2, model 4) plan: each model rank's
     view bytes against the whole-leaf views, the transient gathers apart;
  21. serving across ranks (no hand kernel on it: the reference's serve
     table is GSPMD's): (a) ``repro_torch.launch.serve`` in an NCCL group
     of one through ``--coordinator/--num-processes 1/--process-id 0``,
     qwen2.5-14B at full width, 8 of its 48 bfloat16 layers (the depth cut
     for the time limit), 8 requests in 8 slots: plan (1, 1), tokens and
     cache equal to ``BatchServer`` without a group bit for bit; (b)
     qwen2.5-14B's split decode step at full width, 2 float32 layers, m = 2
     and 4 model ranks as threads of this process
     (``models/tp_ranks.py::DecodeRanks``), the KV cache split on its
     positions (max_len 512) and at m = 4 on its KV heads (510), 8 slots at
     spread positions, 6 steps: the logits against the unsplit step on the
     card (max |difference| over the largest |logit|, 1e-4), each variant's
     step time; (c) granite-moe-3b-a800m's the same way at m = 2 and 4
     (its 48 padded experts split); (d) a qwen2.5-14B rank's parameter and
     KV-cache bytes at (1, 4), 48 layers, 8 slots x 4096, from the serve
     table's shapes (the whole cache 6,442,450,944 bytes, a rank a quarter);
     (e) zamba2-7b the way of (b), 6 of its 81 layers (attention site 5
     in), m = 2 and 4, its Mamba2 state whole on every rank; (f)
     xlstm-350m, 4 of its 24 layers, m = 2 and 4, its states on their
     heads; (g) whisper-large-v3, 2 decoder layers, the cross K/V filled
     from a seeded encoder output, max_len 512 at m = 2 and 4 and 510 at
     m = 4 (its self-attention cache on its KV heads). No hand kernel is
     launched in (b), (c) or (e)-(g);
  22. the dry-run (``repro_torch.launch.costs``, ``lowering``) against the
     card: (a) its analytic kernel costs give phases 2 and 3's bytes bounds
     to the digit; (b) h2o-danube-1.8b (2 bfloat16 layers, train 8 x 128,
     remat) and qwen2.5-14B (2 bfloat16 layers, decode 8 slots x 4096) run
     on the card at a world of one: ``FlopCounterMode``'s count equal to the
     cell's traced on meta, the stored argument bytes equal to the
     predicted, the predicted peak against ``torch.cuda.max_memory_allocated``
     within [0.5, 2]; (c) the wall of one production cell on meta
     (qwen2.5-14B, decode_32k, the (16, 16) pod plan).

Kernel times are device times: a batch of launches back to back between
one pair of CUDA events, over the count. Then one JSON line of per-kernel
numbers (``launches``: phase 4's run; ``launches_by_path``: phases 4, 7, 9,
10, 11a, 12d, 14b, 15b, 15c, 15d, 16b, 17b, 18a, 18b, 18c, 19a, 20b, 21a,
21b-g and 22b), and as the last line ``{"ok": true, "device": {...}}``.
Exits non-zero, and prints no result line, when CUDA is unavailable, when
the package is missing, or when any phase fails. Imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# The card's rates (HBM bytes/s, float32/bfloat16/float64 FLOP/s, SMs and
# special-function results an SM a clock) are the data-sheet table of
# ``repro_torch.launch.costs.H100``, which the dry-run prices with too; run()
# binds them once the package imports.

# Per entropy term f(cnt, pi) with cnt > 0: two log2 and one division on the
# special-function units, and about 24 other float32 operations. A term with
# cnt == 0 is 0 and needs neither. merge_gain adds one division (rel) per
# ordered live pair.
SFU_PER_TERM = 3
FLOPS_PER_TERM = 24

RTOL = 1e-5
ATOL_RED = 1e-3
ATOL_REL = 1e-4

# The query tests' tolerances (tests/test_torch_queries.py), per kind:
# (rtol, atol).
QUERY_TOL = {"degree": (1e-12, 1e-15), "adjacency": (1e-12, 1e-15),
             "pagerank": (1e-9, 1e-12), "triangle": (1e-9, 0.0), "khop": (0.0, 1e-9),
             "cut": (0.0, 1e-9), "conductance": (0.0, 1e-9)}
ALL_KINDS = "degree,adjacency,pagerank,triangle,khop,cut,conductance"
INT_STATS = ("nmerges", "num_supernodes", "num_superedges")
# tests/torch_multihost_check.py's exact keys (the digests line is compared apart)
MULTIHOST_EXACT_KEYS = ("V", "E", "mode", "size_bits", "size_bits_before_sparsify",
                        "relative_size", "re1", "re2", "num_supernodes", "num_superedges",
                        "superedges_dropped")
WIRE_SHAPES = {"w": (33, 7), "b": (13,), "s": ()}  # tests/torch_wire_check.py's
SERVE_REQUESTS = 4096
CPU_SERVE_REQUESTS = 1024  # phase 7b: the CPU engine serves the stream's first 1024
SERVE_SLOTS = 64
# phase 6's edge list, the file of phases 7-11: the skitter stand-in at a
# quarter of its size (the full size's write and parse took 79.4 s)
EDGE_LIST_SCALE = 0.25
SERVE_RANKS_LAYERS = 8  # phase 21a: 8 of qwen2.5-14B's 48 layers (the time limit)
# phase 21b-g: the split decode step against the unsplit on the card, of the
# largest |logit| (float32, TF32 off; the parts add in another order)
SPLIT_DECODE_TOL = 1e-4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def time_cuda(torch, fn, launches: int = 20, batches: int = 5, warmup: int = 2) -> float:
    """Milliseconds of device time a call of ``fn`` takes: ``launches`` calls
    back to back between one pair of CUDA events, over the count; the median
    of ``batches`` such runs. The host's launch cost overlaps the device's
    work, as on the main path."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def time_single(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of one call of ``fn`` between two CUDA events on an
    idle card: the host's launch cost falls inside the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled_ms(torch, fn, kernel: str | None = None, launches: int = 20):
    """Device time, in ms, of one call of ``fn`` under torch.profiler over
    ``launches`` calls: for each kernel (or memset) name that holds
    ``kernel`` (every name when it is None), the mean time of its recorded
    events times how often a call runs it; None when the profiler records no
    such kernel. Means per recorded event, because in a long process the
    profiler has kept fewer records of a ctypes-launched kernel than it ran.
    For a call whose host cost exceeds its device time, back-to-back CUDA
    events would time the host."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
                  and e.count and (kernel is None or kernel in e.key)]
    except RuntimeError:
        return None
    total = sum(e.self_device_time_total / e.count * max(1, round(e.count / launches))
                for e in events)
    return total / 1e3 if total > 0 else None


DADD_PROBE = r"""
#include <cuda_runtime.h>
__global__ void chain(const double* y, double* out, long long* cycles, int reps) {
  double acc = y[1];
  const double d = y[0];
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < 4096; ++i) acc = __dadd_rn(acc, d);
  }
  cycles[0] = clock64() - t0;
  out[0] = acc;
}
extern "C" int chain_launch(const void* y, void* out, void* cycles, int reps, void* stream) {
  chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(y), static_cast<double*>(out),
      static_cast<long long*>(cycles), reps);
  return static_cast<int>(cudaGetLastError());
}
"""


def dadd_latency_ns(torch, build, tmp: str) -> float:
    """Nanoseconds a dependent float64 add takes on the card: one thread adds
    256 chains of 4096 ``__dadd_rn`` back to back, timed by CUDA events (the
    launch is 1/1M of it); the cycle count of ``clock64()`` is logged beside."""
    import ctypes
    src = os.path.join(tmp, "dadd_probe.cu")
    lib_path = os.path.join(tmp, "libdadd_probe.so")
    with open(src, "w") as f:
        f.write(DADD_PROBE)
    out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib_path, src],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on the DADD probe:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(lib_path)
    lib.chain_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    y = torch.tensor([1e-3, 1.0], dtype=torch.float64, device="cuda")
    acc = torch.zeros(1, dtype=torch.float64, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    reps = 256

    def launch():
        err = lib.chain_launch(y.data_ptr(), acc.data_ptr(), cycles.data_ptr(), reps,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"DADD probe launch failed: CUDA error {err}")

    ms = time_cuda(torch, launch, launches=1, batches=3, warmup=1)
    log(f"DADD probe: {int(cycles.item()) / (4096 * reps):.3f} cycles an add by clock64(), "
        f"sum {acc.item()!r}")
    return ms * 1e6 / (4096 * reps)


def gain_operands(g, c, u, seed, dense):
    """The reference's kernel-test operands (tests/test_kernels.py), numpy."""
    rng = np.random.default_rng(seed)
    lam = 2.0 if dense else 0.4
    m = rng.poisson(lam, size=(g, c, u)).astype(np.float32)
    n = rng.integers(1, 40, size=(g, c)).astype(np.float32)
    n[rng.random((g, c)) < 0.2] = 0.0
    s = rng.poisson(0.3, size=(g, c)).astype(np.float32)
    n_u = rng.integers(1, 40, size=(g, u)).astype(np.float32)
    cidx = rng.integers(0, u + 1, size=(g, c)).astype(np.int32)
    w = rng.poisson(0.2, size=(g, c, c)).astype(np.float32)
    w = np.maximum(w, np.swapaxes(w, 1, 2))
    np.einsum("gcc->gc", w)[...] = 0.0
    return m, n, s, n_u, cidx, w


def gain_error(got, want) -> float:
    """Holds (rel, red) against the plain version; returns the max abs error."""
    (rel_g, red_g), (rel_w, red_w) = got, want
    rel_g, red_g, rel_w, red_w = (x.float().cpu().numpy() for x in (rel_g, red_g, rel_w, red_w))
    fin_g, fin_w = np.isfinite(rel_g), np.isfinite(rel_w)
    if not np.array_equal(fin_g, fin_w) or not np.array_equal(np.isneginf(rel_g),
                                                              np.isneginf(rel_w)):
        raise AssertionError(f"-inf masks differ at {int((fin_g != fin_w).sum())} entries")
    np.testing.assert_allclose(red_g, red_w, rtol=RTOL, atol=ATOL_RED)
    np.testing.assert_allclose(rel_g[fin_g], rel_w[fin_w], rtol=RTOL, atol=ATOL_REL)
    err = float(np.abs(red_g - red_w).max(initial=0.0))
    if fin_g.any():
        err = max(err, float(np.abs(rel_g[fin_g] - rel_w[fin_w]).max()))
    return err


def merge_gain_work(torch, gt) -> tuple[float, float]:
    """(entropy terms, ordered live pairs) that the merge-gain function needs
    on these tables: a term for each nonzero entry of m[i] + m[j] over live
    pairs i < j (the cross sum is symmetric in i, j), of a live member's row
    m[i] and self count s[i], and of a live pair's merged self count and w."""
    c = gt.m.shape[1]
    live = gt.n > 0
    nz = (gt.m > 0) & live[..., None]
    nz_row = nz.sum(-1).double()
    n_live = live.sum(-1).double()
    k = nz.sum(1).double()  # live members with a nonzero in each column
    # m >= 0, so nz(m[i] + m[j]) is the union of the two rows' nonzeros:
    # summed over i < j, (L - 1)·Σ|nz_i| − Σ_u k_u(k_u − 1)/2
    cross = float(((n_live - 1).clamp(min=0) * nz_row.sum(-1)).sum()
                  - (k * (k - 1) / 2).sum())
    pairs = live[:, :, None] & live[:, None, :]
    upper = pairs & torch.ones(c, c, dtype=torch.bool, device=gt.m.device).triu(1)
    s_m = gt.s[:, :, None] + gt.s[:, None, :] + gt.w
    epilogue = float(((s_m > 0) & upper).sum() + ((gt.w > 0) & upper).sum())
    rows = float(nz_row.sum() + ((gt.s > 0) & live).sum())
    return cross + rows + epilogue, float(2 * upper.sum())


def dense_gain_operands(torch, gen, g, c, u, dev, scal):
    """gain_operands' dense case (Poisson 2 counts), drawn on the card."""
    def poisson(lam, shape):
        return torch.poisson(torch.full(shape, lam, device=dev), generator=gen)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    m = poisson(2.0, (g, c, u))
    n = ints(1, 40, (g, c)).float()
    n[torch.rand((g, c), generator=gen, device=dev) < 0.2] = 0.0
    s = poisson(0.3, (g, c))
    n_u = ints(1, 40, (g, u)).float()
    cidx = ints(0, u + 1, (g, c)).int()
    w = poisson(0.2, (g, c, c))
    w = torch.maximum(w, w.transpose(1, 2)).contiguous()
    w.diagonal(dim1=1, dim2=2).zero_()
    from repro_torch.kernels import ref
    t = ref.pair_cost_ref(m, n[..., None] * n_u[:, None, :], scal[0], scal[1]).sum(-1) + 5.0
    return m, n, s, t.contiguous(), n_u, cidx, w


def plain_gain_cpu(ref, args, scal):
    """``merge_gain_ref`` on CPU copies of the card's operands: the plain
    version in the reference's own order of additions and log2, which the
    port's tests hold to the JAX reference bit for bit."""
    scal = scal.cpu()
    return ref.merge_gain_ref(*(x.cpu() for x in args), scal[0], scal[1])


def check_gain_shape(got) -> None:
    """The diagonal of rel is -inf and red is symmetric, on the card."""
    rel, red = got
    if not bool(rel.diagonal(dim1=1, dim2=2).isneginf().all()):
        raise AssertionError("diagonal of rel is not -inf")
    red_t = red.transpose(1, 2)
    if not bool(((red - red_t).abs() <= ATOL_RED + RTOL * red_t.abs()).all()):
        raise AssertionError("red is not symmetric")


def partition_coverage(bs, t, p: int) -> list[str]:
    """What is wrong with partition tables ``t`` of the block summary ``bs``
    at ``p`` ranks: the reference's halo-coverage test
    (``tests/test_partition_tables.py::test_halo_coverage``) over the CSR
    entries, and each entry's ``loc_share``/``loc_row`` resolving to a row
    of its own column."""
    indptr = bs.indptr.cpu().numpy()
    cols = bs.cols.cpu().numpy()
    owner, errs = t.owner, []
    s_own, h = t.own_gids.shape[1], t.halo_gids.shape[1]
    ht, dm = t.row_halo_gids.shape[1], t.dense_slots.shape[1]
    tag = f"P={p}, dense_row_nnz={t.dense_row_nnz}"
    for q in range(p):
        own = t.own_gids[q][t.own_gids[q] >= 0]
        if not np.array_equal(own, np.flatnonzero(owner == q)):
            errs.append(f"{tag}: rank {q}'s rows are not the blocks it owns")
        lens = indptr[own + 1] - indptr[own]
        ent = (np.repeat(indptr[own], lens) + np.arange(lens.sum())
               - np.repeat(np.cumsum(lens) - lens, lens))
        ref = cols[ent]
        refs = np.unique(ref)
        remote = refs[owner[refs] != q]
        hl = t.halo_gids[q][t.halo_gids[q] >= 0]
        dense = np.isin(remote, t.dense_gids)
        share_gid = np.concatenate([t.own_gids[q], t.halo_gids[q], [-1]])
        row_gid = np.concatenate([t.own_gids[q], t.row_halo_gids[q], t.dense_slots.reshape(-1),
                                  [-1]])
        ok = (np.array_equal(hl, remote)
              and np.array_equal(t.halo_src_dev[q, :hl.size], owner[hl])
              and np.array_equal(t.halo_src_pos[q, :hl.size], t.block_pos[hl])
              and np.array_equal(t.row_halo_gids[q][t.row_halo_gids[q] >= 0], remote[~dense])
              and t.loc_share[q].size == ent.size and t.loc_row[q].size == ent.size
              and (t.loc_share[q] < s_own + h).all() and (t.loc_row[q] < s_own + ht + p * dm).all()
              and np.array_equal(share_gid[t.loc_share[q]], ref)
              and np.array_equal(row_gid[t.loc_row[q]], ref))
        if not ok:
            errs.append(f"{tag}: rank {q}'s halo does not cover its rows' references")
    return errs


class MoeRecorder:
    """Records every MoE block call (its input and aux) while it is entered:
    ``repro_torch.models.moe.apply_moe`` is wrapped, the transformer calls it
    through the module. Used outside every timed run."""

    def __init__(self, moe_lib):
        self.moe_lib = moe_lib
        self.calls: list[dict] = []

    def __enter__(self):
        self.orig = orig = self.moe_lib.apply_moe

        def recorded(p, x, cfg, capacity_factor=None, **groups):
            y, aux = orig(p, x, cfg, capacity_factor, **groups)
            self.calls.append({"p": p, "x": x, "aux": aux})
            return y, aux

        self.moe_lib.apply_moe = recorded
        return self

    def __exit__(self, *exc):
        self.moe_lib.apply_moe = self.orig

    def drop_fracs(self) -> list[float]:
        return [float(c["aux"]["moe_drop_frac"]) for c in self.calls]


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def card_vs_cpu(torch, cfg, batch, *, tol: float, dec_tol: float | None = None,
                last_only: bool = False):
    """``cfg``'s model seeded on the card: its forward against the same
    weights' forward on the CPU (rtol and atol ``tol``) and, given
    ``dec_tol``, the card's decode against its forward position by position.
    Returns (model, params, forward logits, a log text, failures)."""
    from repro_torch.models.api import build_model
    from repro_torch.models.common import tree_to
    model = build_model(cfg, "cuda")
    params = model.init(0)
    fwd = model.forward(params, batch, last_only=last_only)[0]
    want = build_model(cfg, "cpu").forward(tree_to(params, "cpu"),
                                           {k: v.cpu() for k, v in batch.items()},
                                           last_only=last_only)[0]
    got = fwd.cpu()
    errors = []
    text = (f"forward card vs CPU max abs diff {float((got - want).abs().max()):.3g} "
            f"(|logits| max {float(want.abs().max()):.3g}, rtol and atol {tol:g})")
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        errors.append("forward logits card vs CPU beyond tolerance")
    if dec_tol is not None:
        tokens = batch["tokens"]
        b, n = tokens.shape
        cache = model.init_cache(b, n)
        dec_err, dec_ok = 0.0, True
        for t in range(n):
            lg, cache = model.serve_step(params, {"token": tokens[:, t], "pos": torch.tensor(t),
                                                  "cache": cache})
            dec_err = max(dec_err, float((lg - fwd[:, t]).abs().max()))
            dec_ok &= torch.allclose(lg, fwd[:, t], rtol=dec_tol, atol=dec_tol)
        text += (f"; decode vs forward on the card max abs diff {dec_err:.3g} (rtol and atol "
                 f"{dec_tol:g})")
        if not dec_ok:
            errors.append("decode logits vs forward beyond tolerance")
    return model, params, fwd, text, errors


def serve_twice(cfg, params, prompts, *, slots: int, max_len: int, gen_len: int):
    """``prompts`` through the port's ``BatchServer`` on the card, twice:
    ``[(server, {rid: tokens}, wall_s), ...]``."""
    from repro_torch.launch.serve import BatchServer, Request
    runs = []
    for _ in range(2):
        server = BatchServer(cfg, slots=slots, max_len=max_len, params=params, device="cuda")
        for rid, pr in enumerate(prompts):
            server.submit(Request(rid=rid, prompt=pr, max_new=gen_len))
        t0 = time.perf_counter()
        while server.step():
            pass
        runs.append((server, {r.rid: list(r.out) for r in server.done},
                     time.perf_counter() - t0))
    return runs


def service_line(runs) -> tuple[str, float, int]:
    """The part of a service phase's log line that every LM family shares,
    the median decode step (ms) and the tokens of one run."""
    (s0, out0, w0), (s1, _, w1) = runs
    ntok = sum(len(v) for v in out0.values())
    steps = np.array(s0.step_s + s1.step_s) * 1e3
    med = float(np.median(steps))
    return (f"runs {w0:.3f} s and {w1:.3f} s, {len(s0.step_s)} decode steps a run, median "
            f"step {med:.3f} ms (p10 {np.percentile(steps, 10):.3f}, p90 "
            f"{np.percentile(steps, 90):.3f}); {ntok / w0:.2f} and {ntok / w1:.2f} tokens/s"), \
        med, ntok


def profiled(torch, fn, tag: str, what: str, calls: int = 1) -> None:
    """Logs, over ``calls`` calls of ``fn`` (each ending in a host sync) under
    torch.profiler, the wall of one call, the device's busy time and idle
    share, the ATen calls a call (nested ones included) and its five longest
    kernels by device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            wall = (time.perf_counter() - t0) * 1e3 / calls
        events = prof.key_averages()
    except RuntimeError as exc:
        log(f"{tag} profiler failed ({exc}): device busy time not measured")
        return
    kernels = sorted((e for e in events if e.device_type.name == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    aten = sum(e.count for e in events if e.key.startswith("aten::")) / calls
    top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / calls:.3f}"
                    for e in kernels[:5])
    log(f"{tag} profiled {what}: wall {wall:.3f} ms (profiler on), device busy {busy:.3f} ms, "
        f"idle share {100 * (1 - busy / wall):.1f}%, {aten:.0f} ATen calls (nested "
        f"included); longest kernels (ms a call): {top}")


def profile_decode(torch, model, params, batch, tag: str, steps: int = 3) -> None:
    """:func:`profiled` over ``steps`` decode steps from ``batch``, the token
    ids read back, as the server does."""
    state = {"cache": batch["cache"]}

    def step():
        lg, state["cache"] = model.serve_step(params, dict(batch, cache=state["cache"]))
        torch.argmax(lg, dim=-1).cpu()

    profiled(torch, step, tag, "decode step", steps)


class Smoke:
    """Runs the phases, records which failed, and collects kernel numbers."""

    def __init__(self):
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            log(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:  # a failed phase is reported, the rest still runs
            traceback.print_exc(file=sys.stdout)
            log(f"[{name}] FAIL ({time.perf_counter() - t0:.1f} s)")
            self.failed.append(name)


def run(tmp: str) -> int:
    """The phases; ``tmp`` is a scratch directory for the edge-list file."""
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.core import costs, merge, shingles, summarize, tables
        from repro_torch.core.convert import ReplayPermutations
        from repro_torch.core.engine import LocalBackend
        from repro_torch.core.types import SummaryConfig, SummaryState, init_state, make_graph
        from repro_torch.graphs import generate
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.entropy_bits import pair_cost_triton
        from repro_torch.kernels import merge_gain as merge_gain_lib
        from repro_torch.kernels.merge_gain import merge_gain_cuda
        from repro_torch.utils import f32math
        from repro_torch.launch.costs import H100
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch ({exc}); run it from the "
              "root of the repository", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    HBM_BYTES_PER_S, FP32_FLOPS = H100.hbm_bytes_per_s, H100.fp32_flops
    BF16_FLOPS, FP64_FLOPS = H100.bf16_flops, H100.fp64_flops
    SFU_PER_SM_PER_CLK, NUM_SMS = H100.sfu_per_sm_per_clk, H100.num_sms
    dev = torch.device("cuda")
    smoke = Smoke()
    ctx: dict = {"tmp": tmp}

    # ---- 1. device + build -------------------------------------------------
    def phase_device():
        card = nvidia_smi("name,power.limit")
        clock = nvidia_smi("clocks.max.sm")
        ctx["sm_clock_hz"] = float(clock.split()[0]) * 1e6
        log(card)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}, max SM clock {clock}")
        t0 = time.perf_counter()
        logs = build.build_all()
        cuda_s = time.perf_counter() - t0
        for name, info in logs.items():
            log(f"nvcc {name}.cu: {info['seconds']:.1f} s (cached={info['cached']})")
            for line in info["ptxas"].splitlines():
                if ("ptxas info" in line and "Used" in line) or "spill" in line:
                    log("  " + line.strip())
        t0 = time.perf_counter()
        x = torch.ones(8, device=dev)
        pair_cost_triton(x, x, torch.tensor([1.0, 1.0], device=dev))
        torch.cuda.synchronize()
        log(f"kernels built: CUDA {cuda_s:.1f} s, Triton first compile "
            f"{time.perf_counter() - t0:.1f} s")

    smoke.phase("1 device", phase_device)

    # ---- real round-1 tables of the skitter stand-in (for phases 2-4) ------
    def phase_tables():
        t0 = time.perf_counter()
        src, dst, v = generate("skitter", seed=0, scale=1.0)
        ctx.update(src=src, dst=dst, v=v)
        log(f"skitter stand-in: V={v} E={len(src)} generated in "
            f"{time.perf_counter() - t0:.1f} s")
        cfg = SummaryConfig(T=20, k_frac=0.3, group_size=32, max_neighbors=64,
                            union_size=128, seed=0)
        graph, _ = make_graph(src, dst, v, dev)
        state = init_state(v, dev)
        pt = costs.build_pair_table(graph.src, graph.dst, state)
        metrics = costs.summary_metrics(pt, state, v, graph.num_edges)
        scal = torch.stack([metrics["cbar"], costs.log2_f32(v, dev)])
        perms = shingles.TorchPermutations(cfg.seed, dev)
        groups = shingles.build_groups(graph.src, graph.dst, state, perms, cfg.group_size)
        gt = tables.build_group_tables(pt, state, groups, cfg.max_neighbors,
                                       cfg.union_size, scal, v)
        torch.cuda.synchronize()
        pi = costs.pair_pi(pt, state.size)
        ctx.update(cfg=cfg, gt=gt, scal=scal, pt_cnt=pt.cnt.contiguous(),
                   pt_pi=pi.contiguous(), n_pairs=int(pt.valid.sum()))
        log(f"round-1 tables: G={gt.m.shape[0]} C={gt.m.shape[1]} U={gt.m.shape[2]} "
            f"pairs={ctx['n_pairs']} in {time.perf_counter() - t0:.1f} s")

    smoke.phase("tables", phase_tables)

    # ---- 2. merge_gain kernel against plain --------------------------------
    def phase_merge_gain():
        errs, card_errs = [], []
        shapes = [(1, 4, 8), (3, 8, 16), (2, 16, 32), (5, 32, 64), (4, 64, 256),
                  (2, 13, 100), (3, 7, 45)]
        lib = merge_gain_lib._bind()
        for g, c, u in shapes:
            if lib.merge_gain_smem_bytes(c, u) != merge_gain_lib.smem_bytes(c, u):
                raise AssertionError(f"shared memory of (C={c}, U={u}): the CUDA source "
                                     f"says {lib.merge_gain_smem_bytes(c, u)} B, the "
                                     f"launcher {merge_gain_lib.smem_bytes(c, u)} B")
            for dense in (False, True):
                m, n, s, n_u, cidx, w = gain_operands(g, c, u, g * 100 + u, dense)
                args = [torch.as_tensor(a, device=dev) for a in (m, n, s)]
                scal = torch.tensor([60.0, 20.0], device=dev)
                pi_row = args[1][..., None] * torch.as_tensor(n_u, device=dev)[:, None, :]
                t = (ref.pair_cost_ref(args[0], pi_row, scal[0], scal[1]).sum(-1) + 5.0)
                ops_in = args + [t.contiguous(), torch.as_tensor(n_u, device=dev),
                                 torch.as_tensor(cidx, device=dev),
                                 torch.as_tensor(w, device=dev)]
                got = merge_gain_cuda(*ops_in, scal)
                errs.append(gain_error(got, plain_gain_cpu(ref, ops_in, scal)))
                card_errs.append(gain_error(got, ref.merge_gain_ref(*ops_in, scal[0],
                                                                    scal[1])))
                check_gain_shape(got)
        log(f"merge_gain test shapes {shapes} x sparse/dense: max abs err {max(errs):.3g} "
            f"against the plain version on CPU copies, {max(card_errs):.3g} against the "
            f"plain version on the card")

        # every group of the real round-1 tables, 512 groups at a time
        gt, scal = ctx["gt"], ctx["scal"]
        g_all, c, u = gt.m.shape
        full = (gt.m, gt.n, gt.s, gt.t, gt.n_u, gt.cidx, gt.w, scal)
        got = merge_gain_cuda(*full)
        check_gain_shape(got)
        # on CPU copies: every eighth 512-group block and the 512 groups with
        # the densest rows (all 65,536 groups took 157-180 s of the limit)
        gid = torch.arange(g_all, device=dev)
        densest = gt.m.ne(0).sum(-1).amax(-1).argsort(descending=True, stable=True)[:512]
        cpu_ids = torch.unique(torch.cat([gid[(gid // 512) % 8 == 0], densest]))
        err_real = 0.0
        t0 = time.perf_counter()
        for lo in range(0, len(cpu_ids), 512):
            idx = cpu_ids[lo:lo + 512]
            err_real = max(err_real, gain_error((got[0][idx], got[1][idx]),
                                                plain_gain_cpu(ref, [x[idx] for x in full[:7]],
                                                               scal)))
        cpu_s = time.perf_counter() - t0
        # the plain version on the card adds in the reference's order too
        # (f32math.sum_last); its log2 is the card's
        err_card = 0.0
        for lo in range(0, g_all, 512):
            chunk = [x[lo:lo + 512] for x in full[:7]]
            err_card = max(err_card, gain_error(
                (got[0][lo:lo + 512], got[1][lo:lo + 512]),
                ref.merge_gain_ref(*chunk, scal[0], scal[1])))
        log(f"merge_gain on all G={g_all} real groups against the plain version on the "
            f"card: max abs err {err_card:.3g}")
        valid = int(torch.isfinite(got[0]).sum())
        del got
        nz = gt.m != 0
        row_nnz = nz.sum(-1)
        full_words = int(nz.reshape(g_all, c, -1, 32).all(-1).sum()) if u % 32 == 0 else 0
        log(f"merge_gain on {len(cpu_ids)} of the G={g_all} real groups (every eighth "
            f"block of 512 and the 512 densest) against the plain version on the CPU "
            f"({cpu_s:.0f} s): max abs err {err_real:.3g}; "
            f"{valid} valid entries; rows: at most {int(row_nnz.max())} nonzeros of "
            f"U={u}, {int((row_nnz >= 64).sum())} rows with 64 or more, "
            f"{full_words} full 32-column words")

        sel = torch.linspace(0, g_all - 1, 512, device=dev).long()
        part = [x[sel].contiguous() for x in full[:7]]
        ms_slice = time_cuda(torch, lambda: merge_gain_cuda(*part, scal))
        plain_slice = time_cuda(torch, lambda: ref.merge_gain_ref(*part, scal[0], scal[1]),
                                launches=1, batches=5, warmup=1)
        ms = time_cuda(torch, lambda: merge_gain_cuda(*full))
        prof_ms = profiled_ms(torch, lambda: merge_gain_cuda(*full), "merge_gain_kernel")

        def plain_all():
            for lo in range(0, g_all, 512):
                chunk = [x[lo:lo + 512] for x in full[:7]]
                ref.merge_gain_ref(*chunk, scal[0], scal[1])

        plain_ms = time_cuda(torch, plain_all, launches=1, batches=3, warmup=1)
        terms, ordered_pairs = merge_gain_work(torch, gt)
        bytes_moved = g_all * (c * u + 3 * c * c + 4 * c + u) * 4
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        ctx["merge_gain_bound"] = (g_all, c, u, t_bytes)
        t_sfu = (terms * SFU_PER_TERM + ordered_pairs) / (
            SFU_PER_SM_PER_CLK * NUM_SMS * ctx["sm_clock_hz"]) * 1e3
        t_flops = terms * FLOPS_PER_TERM / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_sfu, t_flops)
        log(f"merge_gain: kernel {ms:.4f} ms on all G={g_all} groups (batched launches; "
            f"profiler {fmt_ms(prof_ms)} ms); 512 groups: kernel {ms_slice:.4f} ms, "
            f"plain {plain_slice:.3f} ms; plain on all G (512-group chunks) "
            f"{plain_ms:.1f} ms; bound {bound:.4f} ms (bytes {t_bytes:.4f}, SFU "
            f"{t_sfu:.4f}, fp32 {t_flops:.4f}; {terms:.6g} nonzero terms, "
            f"{ordered_pairs:.6g} ordered live pairs). The kernel walks only the "
            f"nonzero columns of each live row and of each live pair's union; all U "
            f"columns of each unordered pair would be {g_all * c * (c - 1) / 2 * u:.6g}")

        # the dense case (most of the U columns nonzero) at the real shape
        gen = torch.Generator(device=dev).manual_seed(0)
        dense = dense_gain_operands(torch, gen, g_all, c, u, dev, scal)
        dense_ms = time_cuda(torch, lambda: merge_gain_cuda(*dense, scal))
        chunk = [x[:512] for x in dense]
        err_dense = gain_error(merge_gain_cuda(*chunk, scal),
                               plain_gain_cpu(ref, chunk, scal))
        log(f"merge_gain dense case (Poisson 2 counts, G={g_all} C={c} U={u}): kernel "
            f"{dense_ms:.4f} ms; max abs err on its first 512 groups {err_dense:.3g}")
        del dense, chunk
        smoke.kernels["merge_gain"] = dict(
            name="merge_gain", route="cuda",
            source="src/repro_torch/kernels/csrc/merge_gain.cu",
            replaces="src/repro/kernels/merge_gain.py:109",
            max_abs_err=max(errs + card_errs + [err_real, err_dense, err_card]), ms=ms,
            plain_ms=plain_ms,
            bound_ms=bound, bound_by="bytes" if t_bytes >= max(t_sfu, t_flops)
            else "operations", library_ms=None)

        # first-maximum rule: equal maxima pick the lowest column, all -inf
        # rows pick column 0 and are never accepted
        neg = float("-inf")
        rel = torch.tensor([[[neg, 0.5, 0.5, 0.1], [0.5, neg, 0.2, 0.5],
                             [0.5, 0.2, neg, 0.2], [neg, neg, neg, neg]]])
        members = torch.arange(4)[None]
        for d in (torch.device("cpu"), dev):
            a, b, acc = merge.select_matching(rel.to(d), members.to(d),
                                              torch.tensor(0.0, device=d))
            best = torch.argmax(rel.to(d), dim=-1).cpu().tolist()
            if best != [[1, 0, 0, 0]] or acc.cpu().tolist() != [True, False, False, False]:
                raise AssertionError(f"argmax tie rule on {d}: {best}, {acc.tolist()}")
        log("argmax first-maximum rule and all -inf rows: same on CPU and card")

    smoke.phase("2 merge_gain", phase_merge_gain)

    # ---- 3. pair_cost kernel against plain ---------------------------------
    def phase_pair_cost():
        errs = []
        scal = torch.tensor([45.0, 14.0], device=dev)
        for e in (7, 1025, 5000):
            rng = np.random.default_rng(e)
            cnt = rng.poisson(1.0, size=e).astype(np.float32)
            pi = (cnt + rng.integers(0, 30, size=e)).astype(np.float32)
            for dtype in (torch.float32, torch.int32):
                c_t = torch.as_tensor(cnt, device=dev).to(dtype)
                p_t = torch.as_tensor(pi, device=dev).to(dtype)
                got = pair_cost_triton(c_t, p_t, scal).cpu().numpy()
                want = ref.pair_cost_ref(c_t, p_t, scal[0], scal[1]).cpu().numpy()
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL_REL)
                errs.append(float(np.abs(got - want).max()))
        cnt, pi, scal = ctx["pt_cnt"], ctx["pt_pi"], ctx["scal"]
        got = pair_cost_triton(cnt, pi, scal)
        want = ref.pair_cost_ref(cnt, pi, scal[0], scal[1])
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=RTOL,
                                   atol=ATOL_REL)
        errs.append(float((got - want).abs().max()))
        e = cnt.shape[0]
        ms = time_cuda(torch, lambda: pair_cost_triton(cnt, pi, scal), launches=100)
        single_ms = time_single(torch, lambda: pair_cost_triton(cnt, pi, scal))
        prof_ms = profiled_ms(torch, lambda: pair_cost_triton(cnt, pi, scal),
                              "_pair_cost_kernel", launches=100)
        plain_ms = time_cuda(torch, lambda: ref.pair_cost_ref(cnt, pi, scal[0], scal[1]))
        t_bytes = 12 * e / HBM_BYTES_PER_S * 1e3
        ctx["pair_cost_bound"] = (e, t_bytes)
        live = float((cnt > 0).sum())  # rows past the pair count need no term
        t_sfu = SFU_PER_TERM * live / (SFU_PER_SM_PER_CLK * NUM_SMS * ctx["sm_clock_hz"]) * 1e3
        t_flops = FLOPS_PER_TERM * live / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_sfu, t_flops)
        log(f"pair_cost E in (7, 1025, 5000) x f32/i32 and the real E={e}: max abs err "
            f"{max(errs):.3g}; kernel {ms:.4f} ms (100 launches back to back; "
            f"profiler {fmt_ms(prof_ms)} ms; one launch on an idle card, host launch "
            f"cost included, {single_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{bound:.4f} ms (bytes {t_bytes:.4f}, SFU {t_sfu:.4f}, fp32 {t_flops:.4f})")
        smoke.kernels["pair_cost"] = dict(
            name="pair_cost", route="triton",
            source="src/repro_torch/kernels/entropy_bits.py",
            replaces="src/repro/kernels/entropy_bits.py:34",
            max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if t_bytes >= max(t_sfu, t_flops) else "operations",
            library_ms=None)

    smoke.phase("3 pair_cost", phase_pair_cost)
    ctx.pop("gt", None)
    torch.cuda.empty_cache()

    # ---- 4. the main path at full size -------------------------------------
    def phase_main():
        src, dst, v, cfg = ctx["src"], ctx["dst"], ctx["v"], ctx["cfg"]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = summarize(src, dst, v, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        ctx["main_counts"] = counts
        peak = torch.cuda.max_memory_allocated()
        ctx["res"] = res
        ctx["res_arrays"] = {k: getattr(res, k).copy()
                             for k in ("node2super", "super_size", "edge_w")}
        ctx["res_ints"] = [[h[k] for k in INT_STATS] for h in res.history]
        for k in ("merge_gain", "pair_cost"):
            if k in smoke.kernels:
                smoke.kernels[k]["launches"] = counts[k]
        k_bits = cfg.target_bits(res.input_size_bits)
        rounds = [h["round_s"] * 1e3 for h in res.history]
        log(f"main path: V={v} E={len(src)} iterations={res.iterations_run} "
            f"size_bits={res.size_bits} k_bits={k_bits} relative_size="
            f"{res.size_bits / res.input_size_bits} re1={res.re1} re2={res.re2} "
            f"supernodes={res.num_supernodes} superedges={res.num_superedges} "
            f"wall={wall:.2f} s median round={np.median(rounds):.1f} ms "
            f"max_memory_allocated={peak / 2**30:.2f} GiB launches={counts}")
        log("round ms: " + " ".join(f"{r:.1f}" for r in rounds))
        if not res.size_bits <= k_bits * (1 + 1e-6):
            raise AssertionError(f"size_bits {res.size_bits} over the budget {k_bits}")
        for k in ("size_bits", "re1", "re2", "mdl_cost"):
            if not np.isfinite(getattr(res, k)):
                raise AssertionError(f"{k} is not finite")
        if counts != {"merge_gain": res.iterations_run, "pair_cost": res.iterations_run,
                      "segment_sum": 0, "ordered_sum": 0}:
            raise AssertionError(f"launch counts {counts} != one per round "
                                 f"({res.iterations_run} rounds)")

    smoke.phase("4 main path", phase_main)

    # ---- where a round's time goes (one round-1 replay, stage by stage) ----
    def phase_breakdown():
        src, dst, v, cfg = ctx["src"], ctx["dst"], ctx["v"], ctx["cfg"]
        graph, _ = make_graph(src, dst, v, dev)
        state = init_state(v, dev)
        stages: dict[str, float] = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stages[name] = (time.perf_counter() - t0) * 1e3
            return out

        for _ in range(2):  # the second pass is the one kept (allocator warm)
            pt = stage("pair table", lambda: costs.build_pair_table(graph.src, graph.dst,
                                                                    state))
            met = stage("metrics", lambda: costs.summary_metrics(pt, state, v,
                                                                 graph.num_edges))
            scal = torch.stack([met["cbar"], costs.log2_f32(v, dev)])
            groups = stage("groups", lambda: shingles.build_groups(
                graph.src, graph.dst, state, shingles.TorchPermutations(0, dev),
                cfg.group_size))
            nbr = stage("neighbor tables", lambda: tables.build_neighbor_tables(
                pt, v, cfg.max_neighbors))
            t_all = stage("total costs (pair_cost)", lambda: costs.supernode_total_costs(
                pt, costs.pair_pi(pt, state.size), scal, v))
            gt = stage("group tables", lambda: tables.assemble_group_tables(
                *nbr, t_all, state.size, groups, cfg.union_size, v))
            rel, _red = stage("merge_gain", lambda: ops.merge_gain(
                gt.m, gt.n, gt.s, gt.t, gt.n_u, gt.cidx, gt.w, scal))
            stage("matching + merge", lambda: merge.apply_merges(
                state, *merge.select_matching(rel, gt.members,
                                              torch.tensor(0.5, device=dev))))
        total = sum(stages.values())
        log("round-1 stages (ms, synchronized): " + ", ".join(
            f"{k} {x:.1f}" for k, x in stages.items()) + f"; sum {total:.1f}")
        # what the XLA:CPU-matching log2 (taken on CPU tensors only) would cost
        # the metrics stage, which takes four log2 passes over the E-row pair table
        x = costs.pair_pi(pt, state.size)
        xla_ms = time_cuda(torch, lambda: f32math.log2_xla(x))
        native_ms = time_cuda(torch, lambda: f32math.log2(x))
        log(f"log2 over the E={x.shape[0]} pair table: XLA:CPU emulation {xla_ms:.4f} ms, "
            f"torch.log2 (what the card takes) {native_ms:.4f} ms; x4 passes a round "
            f"in the metrics: {4 * (xla_ms - native_ms):.2f} ms saved")
        prof_acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        perms = shingles.TorchPermutations(0, dev)
        theta = torch.tensor(0.5, device=dev)
        torch.cuda.synchronize()
        try:  # the profiler is a measurement aid: if it fails, say so and go on
            with torch.profiler.profile(activities=prof_acts) as prof:
                t0 = time.perf_counter()
                merge.merge_iteration(graph.src, graph.dst, state, cfg, theta, perms)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        except RuntimeError as exc:
            log(f"profiled round: device time not measured (profiler failed: {exc})")
            return
        busy = sum(e.self_device_time_total for e in events) / 1e3
        if busy <= 0:
            log(f"profiled round: wall {wall:.1f} ms; device time not measured "
                "(the profiler recorded no CUDA kernels)")
            return
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
        log(f"profiled round: wall {wall:.1f} ms (profiler on), device busy {busy:.1f} ms "
            f"({100 * busy / wall:.0f}%), idle share {100 * (1 - busy / wall):.0f}%")
        for e in top:
            log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<4d} {e.key[:90]}")

    smoke.phase("4b round breakdown", phase_breakdown)

    # ---- 4c. a deterministic round: two full-size runs repeat bit for bit ----
    def phase_determinism():
        src, dst, v, cfg = ctx["src"], ctx["dst"], ctx["v"], ctx["cfg"]
        first, first_ints = ctx["res_arrays"], ctx["res_ints"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = summarize(src, dst, v, cfg, device="cuda")
        wall = time.perf_counter() - t0
        ints = [[h[k] for k in INT_STATS] for h in again.history]
        diff_rounds = [i + 1 for i, (a, b) in enumerate(zip(first_ints, ints)) if a != b]
        same = {k: np.array_equal(first[k], getattr(again, k)) for k in first}
        rounds = [h["round_s"] * 1e3 for h in again.history]
        log(f"second full-size run: {again.iterations_run} rounds, wall {wall:.2f} s, median "
            f"round {np.median(rounds):.1f} ms; against phase 4's run: arrays equal {same}, "
            f"integer history equal {ints == first_ints}, first differing round "
            f"{diff_rounds[0] if diff_rounds else None}, node2super entries differing "
            f"{int((first['node2super'] != again.node2super).sum())}")
        # the repaired sum and the index_add_ pair it replaced, on the pair
        # tables of round 1 and of the final partition
        graph, _ = make_graph(src, dst, v, dev)
        states = {"round 1": init_state(v, dev), "final": SummaryState(
            node2super=torch.as_tensor(first["node2super"], device=dev).long(),
            size=torch.as_tensor(first["super_size"], device=dev).long(), t=21)}
        distinct = {}
        for tag, state in states.items():
            pt = costs.build_pair_table(graph.src, graph.dst, state)
            met = costs.summary_metrics(pt, state, v, graph.num_edges)
            scal = torch.stack([met["cbar"], costs.log2_f32(v, dev)])
            pi = costs.pair_pi(pt, state.size)
            cost = torch.where(pt.valid, pair_cost_triton(pt.cnt, pi, scal), 0.0)
            hi_cost = torch.where(pt.lo != pt.hi, cost, 0.0)
            bound = 2.0 * pt.capacity * np.log2(v)

            def atomic():  # the index_add_ pair of the parent's supernode_total_costs
                out = torch.zeros(v, dtype=torch.float32, device=dev)
                return out.index_add_(0, pt.lo, cost).index_add_(0, pt.hi, hi_cost)

            def exact():
                return costs.exact_index_sum(v, (pt.lo, pt.hi), (cost, hi_cost), bound)

            for name, fn in (("index_add_", atomic), ("exact", exact)):
                distinct[f"{name}, {tag}"] = len({fn().cpu().numpy().tobytes()
                                                  for _ in range(5)})
            if not torch.equal(costs.supernode_total_costs(pt, pi, scal, v), exact()):
                raise AssertionError("supernode_total_costs does not take the exact sum")
            # the exact sum, rounded once: float64 adds of these terms (at least
            # 2 bits each, float32) are exact while a total stays below 2^30
            c64, h64 = cost.double().cpu(), hi_cost.double().cpu()
            want = torch.zeros(v, dtype=torch.float64).index_add_(
                0, pt.lo.cpu(), c64).index_add_(0, pt.hi.cpu(), h64)
            chain = torch.zeros(v).index_add_(0, pt.lo.cpu(), cost.cpu()).index_add_(
                0, pt.hi.cpu(), hi_cost.cpu())
            got = exact().cpu()
            if want.max().item() < 2.0 ** 30 and not torch.equal(got, want.float()):
                raise AssertionError(f"{tag}: the exact sum differs from the rounded float64 "
                                     f"sum at {int((got != want.float()).sum())} ids")
            atomic_ms = time_cuda(torch, atomic)
            exact_ms = time_cuda(torch, exact)
            total_ms = time_cuda(torch, lambda: costs.supernode_total_costs(pt, pi, scal, v))
            log(f"total costs, {tag} pair table ({int(pt.valid.sum())} pairs, largest total "
                f"{want.max().item():.6g} bits): the exact sum equals the rounded float64 sum; "
                f"against the CPU's float32 chain {int((got != chain).sum())} of {v} ids "
                f"differ, max abs diff {(got - chain).abs().max().item():.3g}; sum step: "
                f"index_add_ pair {atomic_ms:.4f} ms, exact {exact_ms:.4f} ms; whole function "
                f"(pair_cost kernel included) {total_ms:.4f} ms")
        log(f"distinct results of 5 calls: {distinct}")
        if any(n != 1 for k, n in distinct.items() if k.startswith("exact")):
            raise AssertionError("the exact sum gave different bits from call to call")
        if not (all(same.values()) and ints == first_ints):
            raise AssertionError("two full-size card runs of one config differ")

    smoke.phase("4c determinism", phase_determinism)

    # ---- 5. card against CPU on the golden fixture --------------------------
    def phase_card_vs_cpu():
        src, dst, v = generate("ego-facebook", seed=0, scale=0.08)
        cfg = SummaryConfig(T=10, k_frac=0.3, seed=1)
        rng = np.random.default_rng(1)
        draws = [(rng.permutation(v), rng.permutation(v))
                 for _ in range(cfg.T + cfg.max_extra_iters)]
        cpu = torch.device("cpu")
        round1 = {}
        for d in (cpu, dev):
            be = LocalBackend(src, dst, v, cfg, device=d, perms=ReplayPermutations(draws))
            state = be.init()
            pt = costs.build_pair_table(be.graph.src, be.graph.dst, state)
            groups = shingles.build_groups(be.graph.src, be.graph.dst, state,
                                           ReplayPermutations(draws[:1]), cfg.group_size)
            theta = torch.tensor(0.5, dtype=torch.float32, device=d)
            new_state, stats = merge.merge_iteration(be.graph.src, be.graph.dst, state,
                                                     cfg, theta, ReplayPermutations(draws[:1]))
            round1[d.type] = [x.cpu() for x in (pt.lo, pt.hi, pt.cnt, pt.valid, groups,
                                                new_state.node2super, new_state.size)]
        names = ("pair lo", "pair hi", "pair cnt", "pair valid", "groups",
                 "node2super", "size")
        for name, a, b in zip(names, round1["cpu"], round1["cuda"]):
            if not torch.equal(a, b):
                raise AssertionError(f"round 1 {name} differs between CPU and card")
        log("round 1: pair table, groups and merge set identical on CPU and card")
        runs = {d.type: summarize(src, dst, v, cfg, device=d,
                                  perms=ReplayPermutations(draws)) for d in (cpu, dev)}
        hc, hg = runs["cpu"].history, runs["cuda"].history
        same = [all(a[k] == b[k] for k in ("nmerges", "num_supernodes", "num_superedges"))
                for a, b in zip(hc, hg)]
        first_diff = same.index(False) + 1 if False in same else None
        log(f"later rounds (not asserted; the card adds the total costs exactly, the CPU "
            f"in the reference's float32 order): {len(hc)} CPU "
            f"rounds, {len(hg)} card rounds, integer stats agree in "
            f"{sum(same)}/{min(len(hc), len(hg))}, first difference at round "
            f"{first_diff}; final supernodes CPU {runs['cpu'].num_supernodes} card "
            f"{runs['cuda'].num_supernodes}, size_bits CPU {runs['cpu'].size_bits} "
            f"card {runs['cuda'].size_bits}")

    smoke.phase("5 card vs CPU", phase_card_vs_cpu)

    # ---- 6. edge-list input -------------------------------------------------
    def phase_edge_list():
        from repro_torch.graphs import load_graph, write_edge_list
        t0 = time.perf_counter()
        src, dst, v = generate("skitter", seed=0, scale=EDGE_LIST_SCALE)
        log(f"skitter stand-in at scale {EDGE_LIST_SCALE}: V={v} E={len(src)} generated in "
            f"{time.perf_counter() - t0:.1f} s")
        ctx["file_graph"] = (src, dst, v)
        path = os.path.join(ctx["tmp"], "skitter.txt")
        t0 = time.perf_counter()
        write_edge_list(path, src, dst, v, shuffle=True, dup_frac=0.01, self_loops=100,
                        header=True)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g = load_graph(path)
        ingest_s = time.perf_counter() - t0
        st = g.stats
        log(f"edge list: {os.path.getsize(path)} bytes, {st.lines_parsed} lines, written in "
            f"{write_s:.1f} s; ingest {ingest_s:.1f} s (source={g.source}, {st.chunks} chunks, "
            f"{st.spill_runs} runs, {st.duplicates_dropped} duplicates and "
            f"{st.self_loops_dropped} self-loops dropped, relabeled={st.relabeled})")
        for name, got in (("ingest", g), ("cache hit", None)):
            if got is None:
                t0 = time.perf_counter()
                got = load_graph(path)
                hit_s = time.perf_counter() - t0
                if got.source != "cache" or got.stats.bytes_parsed != 0:
                    raise AssertionError(f"second load: source={got.source}, "
                                         f"{got.stats.bytes_parsed} bytes parsed")
                log(f"cache hit: {hit_s:.3f} s, 0 bytes parsed")
            if not (got.num_nodes == v and np.array_equal(np.asarray(got.src), src)
                    and np.array_equal(np.asarray(got.dst), dst)):
                raise AssertionError(f"{name}: the graph read back is not generate()'s "
                                     f"(V {got.num_nodes} vs {v}, E {got.num_edges} vs "
                                     f"{len(src)})")
        log(f"read back: identical to generate('skitter', seed=0, scale={EDGE_LIST_SCALE})")
        ctx["edge_list"] = path

    smoke.phase("6 edge-list input", phase_edge_list)

    # ---- 7. query serving, end to end ----------------------------------------
    def phase_serve():
        from repro_torch.launch import query_serve
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = query_serve.main(["--edge-list", ctx["edge_list"], "--T", "20", "--k-frac", "0.3",
                                "--requests", str(SERVE_REQUESTS), "--batch", str(SERVE_SLOTS),
                                "--queries", ALL_KINDS, "--device", "cuda"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ctx["serve_counts"] = counts
        ctx["serve_out"] = out
        log(f"served: {out['requests']} requests {out['queries']} in {SERVE_SLOTS} slots, "
            f"p50 {out['p50_latency_s'] * 1e3:.2f} ms, p99 {out['p99_latency_s'] * 1e3:.2f} ms, "
            f"QPS {out['qps']:.1f}; summarize {out['summarize_wall_s']:.2f} s "
            f"({out['iterations']} rounds), engine build {out['engine_build_wall_s']:.3f} s, "
            f"load {out['load_wall_s']:.3f} s (source={out['source']}); blocks {out['blocks']}, "
            f"PageRank steps {out['pagerank_iterations']}, wedges {out['triangle_wedges']}; "
            f"digest {out['answers_digest']}; launches {counts}")
        if out["requests"] != SERVE_REQUESTS or set(out["queries"]) != set(ALL_KINDS.split(",")):
            raise AssertionError(f"served {out['requests']} requests of {out['queries']}")
        rounds = out["iterations"]
        if counts["merge_gain"] != rounds or counts["pair_cost"] != rounds:
            raise AssertionError(f"launch counts {counts} != one per round ({rounds} rounds)")
        for k in ("segment_sum", "ordered_sum"):
            if counts[k] == 0:
                raise AssertionError(f"the query path never launched {k}")

    smoke.phase("7 query serving", phase_serve)

    # ---- 7b. queries, card against CPU ---------------------------------------
    def phase_queries_card_vs_cpu():
        from repro_torch.core.query_engine import KIND_NAMES, QueryEngine
        from repro_torch.launch.query_serve import (QueryServer, answers_digest,
                                                    random_workload, serve)
        res, v = ctx["res"], ctx["v"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        card = QueryEngine(res, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() - base
        bs = card.bs
        resident = sum(x.numel() * x.element_size() for x in (
            bs.ids, bs.node2block, bs.sizes, bs.indptr, bs.cols, bs.sigma, bs.deg_w, bs.deg,
            bs.rows, bs.key))
        t0 = time.perf_counter()
        cpu = QueryEngine(dataclasses.replace(res), device="cpu")
        cpu_build_s = time.perf_counter() - t0
        kinds = [KIND_NAMES[k] for k in ALL_KINDS.split(",")]
        t0 = time.perf_counter()
        reqs = random_workload(np.random.default_rng(0), v, SERVE_REQUESTS, kinds)
        draw_s = time.perf_counter() - t0

        def run(engine, stream):
            server = QueryServer(engine, slots=SERVE_SLOTS)
            torch.cuda.reset_peak_memory_stats()
            wall = serve(server, [dataclasses.replace(r) for r in stream])
            return ({r.rid: r.answer for r in server.done}, answers_digest(server.done), wall,
                    torch.cuda.max_memory_allocated())

        a1, d1, w1, serve_peak = run(card, reqs)
        card2 = QueryEngine(dataclasses.replace(res), device="cuda")  # built anew
        a2, d2, w2, _ = run(card2, reqs)
        # the CPU serves the stream's first CPU_SERVE_REQUESTS (an answer does
        # not depend on the batch it is served in)
        a3, d3, w3, _ = run(cpu, reqs[:CPU_SERVE_REQUESTS])
        tri = card.triangle_density()
        log(f"block summary: S={bs.num_blocks} nnz={bs.nnz} D={bs.max_row_nnz()} "
            f"rows with entries {int((bs.indptr[1:] > bs.indptr[:-1]).sum())}; "
            f"wedges {card.triangle_wedges}, triangle total {tri!r}; PageRank steps card "
            f"{card.pagerank_iterations}, {card2.pagerank_iterations}, CPU "
            f"{cpu.pagerank_iterations}")
        log(f"engine build: card {build_s:.3f} s, peak {build_peak / 2**20:.1f} MiB above the "
            f"{base / 2**20:.1f} MiB already held, block summary resident "
            f"{resident / 2**20:.1f} MiB; CPU {cpu_build_s:.3f} s; workload drawn in "
            f"{draw_s:.1f} s; serve {SERVE_REQUESTS} requests: card {w1:.2f} s and {w2:.2f} s "
            f"(peak memory while serving {serve_peak / 2**30:.2f} GiB); the first "
            f"{CPU_SERVE_REQUESTS}: CPU {w3:.2f} s")
        worst = {}
        kind_of = {r.rid: k for r in reqs for k, n in KIND_NAMES.items() if n == r.kind}
        if (len(a1), len(a3)) != (SERVE_REQUESTS, CPU_SERVE_REQUESTS):
            raise AssertionError(f"served {len(a1)} requests on the card and {len(a3)} on the "
                                 f"CPU, not {SERVE_REQUESTS} and {CPU_SERVE_REQUESTS}")
        for rid, got in a1.items():
            if not np.isfinite(got):
                raise AssertionError(f"request {rid} ({kind_of[rid]}): answer {got}")
        for rid, want in a3.items():
            got = a1[rid]
            rtol, atol = QUERY_TOL[kind_of[rid]]
            diff = abs(got - want)
            w = worst.setdefault(kind_of[rid], [0.0, 0])
            w[0] = max(w[0], diff)
            w[1] += diff > atol + rtol * abs(want)
        log("card against CPU, max abs difference per kind: " + ", ".join(
            f"{k} {w[0]:.3g}" for k, w in sorted(worst.items())))
        same = sum(a1[rid] == want for rid, want in a3.items())
        log(f"digests: card {d1}, card again {d2}; CPU's {CPU_SERVE_REQUESTS} {d3}, "
            f"{same} of them equal to the card's bit for bit")
        if d1 != d2:
            raise AssertionError("two card runs of one workload gave different answers")
        bad = {k: w[1] for k, w in worst.items() if w[1]}
        if bad:
            raise AssertionError(f"answers outside the tolerances, per kind: {bad}")
        if not card.pagerank_iterations == card2.pagerank_iterations == cpu.pagerank_iterations:
            raise AssertionError("PageRank took different numbers of steps")
        ctx["bs_card"], ctx["pr_card"], ctx["reqs"] = bs, card.pagerank_blocks(), reqs

    smoke.phase("7b queries card vs CPU", phase_queries_card_vs_cpu)

    # ---- 7c. the fixed-order sum kernels against plain ---------------------
    def phase_segment_sum():
        from repro_torch.core.queries import SUM_SEGMENT
        from repro_torch.kernels.segment_sum import (LONG_ROW, long_rows, ordered_sum_cuda,
                                                     segment_sum_cuda)

        dadd_ns = dadd_latency_ns(torch, build, ctx["tmp"])
        log(f"dependent float64 add latency: {dadd_ns:.3f} ns (one thread, a chain of 4096 "
            f"__dadd_rn; {dadd_ns * ctx['sm_clock_hz'] / 1e9:.2f} cycles at the max SM clock)")
        timed_rows = {}  # shape -> dict of its times and bounds, ms

        def timings(name, call, library, nbytes, chain):
            """Device time of the kernel and of the library call (profiler; the
            back-to-back time of the kernel's calls beside, which a launch's host
            cost bounds below), and the two-term bound: bytes at the HBM rate,
            and the longest chain of dependent adds at the measured latency."""
            back = time_cuda(torch, call, launches=100)
            ms = profiled_ms(torch, call, launches=50)
            lib = profiled_ms(torch, library, launches=50)
            timed_rows[name] = dict(
                ms=back if ms is None else ms, back=back, profiled=ms is not None,
                lib=time_cuda(torch, library, launches=100) if lib is None else lib,
                bytes=nbytes / HBM_BYTES_PER_S * 1e3, chain=chain * dadd_ns * 1e-6)

        def check(indptr, vals, tag, timed=True):
            """The CSR kernel against the plain version on CPU copies and against
            np.add.at, to the last bit; times it beside torch.segment_reduce;
            returns the kernel's result."""
            long = long_rows(indptr)
            got = segment_sum_cuda(indptr, vals, long)
            plain = ref.segment_sum_ref(indptr.cpu(), vals.cpu())
            ip = indptr.cpu().numpy()
            want = np.zeros(ip.size - 1)
            np.add.at(want, np.repeat(np.arange(ip.size - 1), np.diff(ip)),
                      vals.cpu().numpy()[:ip[-1]])
            got_h = got.cpu().numpy()
            if not (np.array_equal(got_h, plain.numpy()) and np.array_equal(got_h, want)):
                raise AssertionError(f"segment_sum {tag} differs: max abs err "
                                     f"{np.abs(got_h - want).max()}")
            if not torch.equal(segment_sum_cuda(indptr, vals), got):
                raise AssertionError(f"segment_sum {tag}: the list computed in the wrapper "
                                     "gives other bits")
            if timed:
                s_, n_ = ip.size - 1, int(ip[-1])
                widest = int(np.diff(ip).max(initial=0))
                timings(f"csr {tag}", lambda: segment_sum_cuda(indptr, vals, long),
                        lambda: torch.segment_reduce(vals, "sum", offsets=indptr),
                        8 * (s_ + 1) + 8 * n_ + 8 * s_ + 8 * long.numel(), widest)
            return got

        def check_ordered(x, tag, timed=True):
            """ordered_sum against its plain version on a CPU copy, to the last
            bit, and run to run; times it beside x.sum(-1); returns its result."""
            got = ordered_sum_cuda(x, SUM_SEGMENT)
            want = ref.ordered_sum_ref(x.cpu(), SUM_SEGMENT)
            if not (torch.equal(got.cpu(), want) and torch.equal(ordered_sum_cuda(x), got)):
                raise AssertionError(f"ordered_sum {tag} differs: max abs err "
                                     f"{(got.cpu() - want).abs().max().item()}")
            k, n = x.shape
            if timed and k and n:
                m = -(-n // SUM_SEGMENT)
                timings(f"ordered_sum {tag}", lambda: ordered_sum_cuda(x, SUM_SEGMENT),
                        lambda: x.sum(-1), 8 * k * n + 8 * k,
                        min(n, SUM_SEGMENT) + (m if m > 1 else 1))
            return got

        rng = np.random.default_rng(0)

        def spread(n):  # values of mixed sign over about ±8 decades
            return rng.standard_normal(n) * np.exp(rng.standard_normal(n) * 8)

        hubs = rng.poisson(0.45, 200_000)
        hubs[rng.integers(0, hubs.size, 30)] = 2500
        shapes = {"mixed": [0, 3, 0, 0, 5, 1], "ones": [1] * 50, "empty": [0] * 7,
                  "wide": [4000, 0, 2, 3000], "hubs": hubs.tolist(),
                  "31/32/33/1024": [31, 32, 33, 1024, 0, 33, 31] * 40}
        for tag, lengths in shapes.items():
            n = int(np.sum(lengths))
            indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
            check(torch.as_tensor(indptr, device=dev), torch.as_tensor(spread(n), device=dev),
                  tag)
        bs, pr = ctx["bs_card"], ctx["pr_card"]
        share = torch.where(bs.deg > 0, pr / torch.clamp(bs.deg, min=1e-300), 0.0)
        step = (bs.deg_w * share[bs.cols]).contiguous()  # a PageRank step's products
        got = check(bs.indptr, step, "PageRank step")
        if not torch.equal(check(bs.indptr, bs.deg_w, "deg", timed=False), bs.deg):
            raise AssertionError("segment_sum of deg_w is not the block summary's deg")
        if not torch.equal(segment_sum_cuda(bs.indptr, step, bs.long_rows), got):
            raise AssertionError("two launches on one input differ")
        # whether a PyTorch call gives these row sums (np.add.at's order, the
        # same on every run): each taken twice on the card
        want = got.cpu().numpy()
        rows = torch.repeat_interleave(torch.arange(bs.num_blocks, device=dev),
                                       bs.indptr[1:] - bs.indptr[:-1])
        calls = {
            "index_add_": lambda: torch.zeros_like(got).index_add_(0, rows, step),
            "scatter_add_": lambda: torch.zeros_like(got).scatter_add_(0, rows, step),
            "segment_reduce": lambda: torch.segment_reduce(step, "sum", offsets=bs.indptr)}
        verdicts = []
        for name, call in calls.items():
            a, b = call().cpu().numpy(), call().cpu().numpy()
            verdicts.append(f"{name}: runs equal {np.array_equal(a, b)}, np.add.at's "
                            f"{np.array_equal(a, want) and np.array_equal(b, want)}, max abs "
                            f"diff {np.abs(a - want).max():.3g}")
        x = step.repeat(SERVE_SLOTS).reshape(SERVE_SLOTS, -1) * 1e3
        whole = x.sum(-1)
        rowwise = torch.stack([x[i:i + 1].sum(-1)[0] for i in range(SERVE_SLOTS)])
        verdicts.append(f"torch.sum of a [64, nnz] tensor's rows equal to each row's own "
                        f"sum: {torch.equal(whole, rowwise)} (max diff "
                        f"{(whole - rowwise).abs().max().item():.3g})")
        log("PyTorch calls on the PageRank step's row sums: " + "; ".join(verdicts))

        # ordered_sum: empty and ragged rows, then the query path's five shapes
        for k, n in ((0, 5), (3, 0), (1, 1023), (1, 1024), (1, 1025), (9, 1023), (9, 1024),
                     (9, 1025), (64, 1023), (64, 1024), (64, 1025)):
            check_ordered(torch.as_tensor(spread(k * n).reshape(k, n), device=dev),
                          f"[{k}, {n}]")
        s, nnz = bs.num_blocks, bs.nnz
        gen = torch.Generator(device=dev).manual_seed(0)
        terms = {}
        for k, n, tag in ((1, s, "S"), (9, s, "S"), (64, s, "S"), (9, nnz, "nnz"),
                          (64, nnz, "nnz")):
            x = torch.randn(k, n, dtype=torch.float64, device=dev, generator=gen)
            x = x * torch.exp(8 * torch.randn(k, n, dtype=torch.float64, device=dev,
                                              generator=gen))
            check_ordered(x, f"[{k}, {tag}]")
            terms[(k, tag)] = x
        dangling = torch.where(bs.deg <= 0, pr * bs.sizes, 0.0)[None]  # PageRank's own
        check_ordered(dangling.contiguous(), "[1, S] dangling mass", timed=False)
        for name, r in timed_rows.items():
            bound = max(r["bytes"], r["chain"])
            how = "device time" if r["profiled"] else "back to back"
            log(f"  {name}: kernel {r['ms']:.4f} ms ({how}; back to back {r['back']:.4f}), "
                f"{'torch.segment_reduce' if name.startswith('csr') else 'x.sum(-1)'} "
                f"{r['lib']:.4f} ms, bound {bound:.4f} ms (bytes {r['bytes']:.4f}, chain "
                f"{r['chain']:.4f}), {100 * bound / r['ms']:.0f}% of it")
        csr, dense = timed_rows["csr PageRank step"], timed_rows["ordered_sum [9, nnz]"]
        x = terms[(9, "nnz")]
        ord_plain = time_cuda(torch, lambda: ref.ordered_sum_ref(x, SUM_SEGMENT))
        plain_ms = time_cuda(torch, lambda: ref.segment_sum_ref(bs.indptr, step))
        t_bytes = (8 * (s + 1) + 8 * nnz + 8 * s + 8 * bs.long_rows.numel()) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = nnz / FP64_FLOPS * 1e3
        ob_bytes = (8 * x.numel() + 8 * x.shape[0]) / HBM_BYTES_PER_S * 1e3
        ob_ops = x.numel() / FP64_FLOPS * 1e3
        log(f"segment_sum on test shapes and the block CSR (S={s} rows, nnz={nnz} values, "
            f"{bs.long_rows.numel()} rows over {LONG_ROW} values, widest {bs.max_row_nnz()}; "
            f"deg, a PageRank step) and ordered_sum on empty, ragged and the query path's "
            f"shapes: equal to the plain versions (and the CSR to np.add.at) bit for bit, and "
            f"run to run. Plain versions on the card: PageRank step {plain_ms:.4f} ms, "
            f"ordered_sum [9, nnz] {ord_plain:.4f} ms")
        smoke.kernels["segment_sum"] = dict(
            name="segment_sum", route="cuda",
            source="src/repro_torch/kernels/csrc/segment_sum.cu",
            replaces="src/repro/core/queries_jax.py:181",
            launches=ctx["serve_counts"]["segment_sum"], max_abs_err=0.0, ms=csr["ms"],
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=csr["lib"],
            ms_back_to_back=csr["back"], two_term_bound_ms=max(csr["bytes"], csr["chain"]))
        smoke.kernels["ordered_sum"] = dict(
            name="ordered_sum", route="cuda",
            source="src/repro_torch/kernels/csrc/segment_sum.cu",
            replaces="src/repro/core/queries.py:198",
            launches=ctx["serve_counts"]["ordered_sum"], max_abs_err=0.0, ms=dense["ms"],
            plain_ms=ord_plain, bound_ms=max(ob_bytes, ob_ops),
            bound_by="bytes" if ob_bytes >= ob_ops else "operations", library_ms=dense["lib"],
            ms_back_to_back=dense["back"],
            two_term_bound_ms=max(dense["bytes"], dense["chain"]))

    smoke.phase("7c fixed-order sums", phase_segment_sum)

    # ---- 7d. where a serving step's time goes --------------------------------
    def phase_query_breakdown():
        from repro_torch.core.query_engine import KIND_NAMES, SET_KINDS, QueryEngine, \
            pack_set_counts
        from repro_torch.launch.query_serve import QueryServer, serve
        reqs = ctx.pop("reqs")

        def timed(fn, reps=3):
            """Median host seconds of ``fn`` between two synchronizes, and its value."""
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return float(np.median(times)), out

        res = dataclasses.replace(ctx["res"])
        build_s, eng = timed(lambda: QueryEngine(dataclasses.replace(res), device="cuda"), 1)
        pr_s, _ = timed(eng.pagerank_blocks, 1)
        tri_s, _ = timed(eng.triangle_density, 1)
        parts = [f"engine build {build_s * 1e3:.1f} ms, PageRank ({eng.pagerank_iterations} "
                 f"steps) {pr_s * 1e3:.1f} ms, triangles ({eng.triangle_wedges} wedges) "
                 f"{tri_s * 1e3:.1f} ms"]
        for name, k in KIND_NAMES.items():
            batch = [r for r in reqs if r.kind == k][:SERVE_SLOTS]
            kinds = np.full(len(batch), k, np.int32)
            u = np.array([r.u for r in batch])
            v = np.array([r.v for r in batch])
            counts = (None, None, None)
            pack = ""
            if k in SET_KINDS:
                pack_s, counts = timed(lambda: pack_set_counts(
                    eng.bs, kinds, [r.a for r in batch], [r.b for r in batch]))
                pack = f" + packing {pack_s * 1e3:.2f} ms"
            ans_s, _ = timed(lambda: eng.answer_batch(kinds, u, v, *counts))
            parts.append(f"{name} {ans_s * 1e3:.2f} ms{pack}")
        log(f"a {SERVE_SLOTS}-slot batch of one kind, host wall between synchronizes: "
            + ", ".join(parts))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        server = QueryServer(eng, slots=SERVE_SLOTS)
        steps = 8
        chunk = [dataclasses.replace(r) for r in reqs[:steps * SERVE_SLOTS]]
        try:  # a measurement aid: if the profiler fails, say so and go on
            with torch.profiler.profile(activities=acts) as prof:
                wall = serve(server, chunk)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        except RuntimeError as exc:
            log(f"profiled serving: device time not measured (profiler failed: {exc})")
            return
        busy = sum(e.self_device_time_total for e in events) / 1e6
        if busy <= 0:
            log(f"profiled serving: wall {wall:.3f} s; device time not measured")
            return
        log(f"profiled serving, {steps} steps of {SERVE_SLOTS} mixed requests: wall "
            f"{wall * 1e3:.1f} ms (profiler on), device busy {busy * 1e3:.1f} ms "
            f"({100 * busy / wall:.0f}%), idle share {100 * (1 - busy / wall):.0f}%")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")

    smoke.phase("7d query breakdown", phase_query_breakdown)


    # ---- 8. checkpoint, preemption and resume through the launcher ----------
    def phase_resume():
        import argparse
        from repro_torch.launch import chaos
        from repro_torch.launch.summarize import digest
        args = argparse.Namespace(edge_list=ctx["edge_list"], dataset=None, scale=1.0,
                                  k_frac=0.3, T=20, seed=0, group_size=32, driver_chunk=2,
                                  checkpoint_every=1, checkpoint_keep=3, device="cuda",
                                  timeout=300.0)
        env = chaos.launcher_env()
        work = os.path.join(ctx["tmp"], "resume")
        os.makedirs(work)
        t0 = time.perf_counter()
        golden = chaos.run_to_completion(chaos.launcher_cmd(args), env, args.timeout)
        golden_s = time.perf_counter() - t0
        want = golden["digests"].split()[0]
        # phase 4's config in this process on the file's graph (driver_chunk 8)
        fsrc, fdst, fv = ctx["file_graph"]
        run4 = summarize(fsrc, fdst, fv, ctx["cfg"], device="cuda")
        in_process = f"node2super={digest(run4.node2super)}"
        if want != in_process:
            raise AssertionError(f"the launcher's golden ({want}) differs from phase 4's "
                                 f"config run in this process ({in_process})")
        vs_phase4 = "equal to phase 4's config run in this process (driver_chunk 8)"
        log(f"golden (no checkpoints, driver_chunk 2): {golden['iterations']} rounds, summarize "
            f"wall {golden['wall_s']:.2f} s ({golden_s:.1f} s with start-up and load), "
            f"launches {golden['kernel_launches']}; {want[:27]}..., {vs_phase4}")
        errors = []
        for signame, step in (("TERM", 6), ("KILL", 12)):
            scen = chaos.run_scenario(args, golden, signame, step, work, env)
            resumed = scen.get("resumed", {})
            launches = resumed.get("kernel_launches", {})
            rounds = resumed.get("iterations", 0) - (resumed.get("resumed_from") or 0)
            log(f"SIG{signame} once step {step} committed (step {scen['step_seen']} seen): exit "
                f"{scen['kill_rc']}, preempted at step {scen.get('preempt_step')}; resumed "
                f"from step {scen.get('resume_from')}: {rounds} rounds, launches {launches}, "
                f"summarize wall {resumed.get('wall_s', float('nan')):.2f} s; exact keys "
                f"and digests equal to the golden: {not scen['errors']}")
            saves = resumed.get("checkpoint_saves")
            if saves:  # --checkpoint-every 1 from the resumed step on
                log(f"  its {saves} saves of {resumed['checkpoint_bytes']} bytes a step: snapshot "
                    f"(the loop's stall) {resumed['checkpoint_snapshot_wall_s'] / saves * 1e3:.2f}"
                    f" ms a save, write (writer thread) "
                    f"{resumed['checkpoint_write_wall_s'] / saves * 1e3:.1f} ms a save")
            errors += scen["errors"]
            if scen.get("outcome") != "resumed":
                errors.append(f"SIG{signame}: the run was not resumed ({scen.get('outcome')})")
            if signame == "TERM" and scen["kill_rc"] != chaos.RESUMABLE_EXIT:
                errors.append(f"SIGTERM exit {scen['kill_rc']}")
            if any(launches.get(k) != rounds for k in ("merge_gain", "pair_cost")):
                errors.append(f"SIG{signame}: launches {launches} != one per resumed round "
                              f"({rounds})")
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("8 checkpoint and resume", phase_resume)

    # ---- 9. edge-sharded: --distributed at a world of one over NCCL --------
    def phase_distributed():
        import contextlib
        import io

        import torch.distributed as tdist
        from repro_torch.core.distributed import bucket_bytes
        from repro_torch.graphs.feed import shard_edges_from_cache
        from repro_torch.launch import summarize as launch

        rank, world, _ = launch.init_distributed(dev)  # the launcher keeps this group
        log(f"process group: {tdist.get_backend()}, rank {rank} of {world}")
        args = ["--edge-list", ctx["edge_list"], "--T", "20", "--k-frac", "0.3",
                "--distributed", "--device", "cuda"]
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out = launch.main(args)
            torch.cuda.synchronize()
            digests = [ln for ln in buf.getvalue().splitlines() if ln.startswith("digests")]
            runs.append((out, digests[0], ops.launch_counts(), torch.cuda.max_memory_allocated()))
        (out, dig, counts, peak), (out2, dig2, _, _) = runs
        ctx["dist_run"] = (out, dig)
        hist = out["history"]
        rounds_ms = [h["round_s"] * 1e3 for h in hist]
        log(f"--distributed (compact, capacity factor 32, world {world}, {out['backend']}): "
            f"{out['iterations']} rounds, size_bits {out['size_bits']} (before the drop "
            f"{out['size_bits_before_sparsify']}), relative_size {out['relative_size']}, "
            f"re1 {out['re1']}, supernodes {out['num_supernodes']}, superedges "
            f"{out['num_superedges']}, dropped {out['superedges_dropped']}; median round "
            f"{np.median(rounds_ms):.1f} ms, summarize wall {out['wall_s']:.2f} s, feed "
            f"{out['feed_wall_s'] * 1e3:.1f} ms ({out['feed_path']}, {out['feed_shard_rows']} "
            f"rows, staging {out['feed_peak_staging_bytes']} B), sparsify "
            f"{out['sparsify_wall_s'] * 1e3:.1f} ms, load {out['load_wall_s']:.3f} s "
            f"(source={out['source']}); peak device memory {peak / 2**30:.2f} GiB; bucket "
            f"capacity {out['bucket_cap']} records, {out['bucket_bytes']} bytes a round; "
            f"launches {counts}")
        log("round ms: " + " ".join(f"{r:.1f}" for r in rounds_ms))
        errors = []
        exact = ("size_bits", "size_bits_before_sparsify", "num_supernodes",
                 "num_superedges", "superedges_dropped", "iterations")
        ints = [[h[k] for k in ("nmerges", "num_supernodes", "num_superedges", "size_bits")]
                for h in hist]
        ints2 = [[h[k] for k in ("nmerges", "num_supernodes", "num_superedges", "size_bits")]
                 for h in out2["history"]]
        same = dig == dig2 and ints == ints2 and all(out[k] == out2[k] for k in exact)
        log(f"second run: {dig2 == dig and 'same digests' or 'digests differ'}, exact keys "
            f"and per-round stats equal: {same}")
        if not same:
            errors.append("two --distributed runs differ")
        if any(h["overflow"] != 0 for h in hist):
            errors.append("bucket overflow")
        if not out["relative_size"] <= 0.3 * (1 + 1e-6):
            errors.append(f"relative size {out['relative_size']} over k_frac 0.3")
        # Eq. (4) charges each superedge log2(ω_max) bits: the size may rise
        # in a round where ω_max rises, and only there
        sizes = [h["size_bits"] for h in hist]
        omegas = [h["omega_max"] for h in hist]
        rose = [i + 1 for i in range(1, len(sizes)) if sizes[i] > sizes[i - 1]]
        log(f"size_bits a round: {sizes}; ω_max a round: {omegas}; rounds whose size "
            f"rose: {rose}")
        if any(omegas[r - 1] <= omegas[r - 2] for r in rose) or not sizes[-1] < sizes[0]:
            errors.append("the size rose in a round where ω_max did not, or did not shrink")
        n = out["iterations"]
        if counts != {"merge_gain": n, "pair_cost": n, "segment_sum": 0, "ordered_sum": 0}:
            errors.append(f"launch counts {counts} != one of each per round ({n} rounds)")
        for k in ("merge_gain", "pair_cost"):
            smoke.kernels.setdefault(k, {}).setdefault("launches_by_path", {})[
                "edge-sharded"] = counts[k]

        # the kernels at the new call sites, on round 1's compact tables
        sh = shard_edges_from_cache(ctx["edge_list"] + ".ssummcache", rank, world, dev)
        be = launch.build_distributed_pipeline(ctx["cfg"], ctx["file_graph"][2], sh.num_edges,
                                               dev)
        be.bind(sh.src, sh.dst)
        state = be.init()
        r = be.compact_tables(sh.src, sh.dst, state)
        gt, scal = r["gt"], r["scal"]
        full = (gt.m, gt.n, gt.s, gt.t, gt.n_u, gt.cidx, gt.w)
        got = merge_gain_cuda(*full, scal)
        g_all = gt.m.shape[0]
        err_card = 0.0
        for lo in range(0, g_all, 512):
            chunk = [x[lo:lo + 512] for x in full]
            err_card = max(err_card, gain_error((got[0][lo:lo + 512], got[1][lo:lo + 512]),
                                                ref.merge_gain_ref(*chunk, scal[0], scal[1])))
        sel = torch.linspace(0, g_all - 1, 1024, device=dev).long()
        err_cpu = gain_error((got[0][sel], got[1][sel]),
                             plain_gain_cpu(ref, [x[sel] for x in full], scal))
        size = state.size
        na = size[r["glo"]].float()
        nb = size[r["ghi"]].float()
        pi = torch.where(r["glo"] == r["ghi"], na * (na - 1.0) * 0.5, na * nb).contiguous()
        cnt = r["gcnt"].contiguous()
        pc = pair_cost_triton(cnt, pi, scal)
        pc_want = ref.pair_cost_ref(cnt, pi, scal[0], scal[1])
        np.testing.assert_allclose(pc.cpu().numpy(), pc_want.cpu().numpy(), rtol=RTOL,
                                   atol=ATOL_REL)
        err_pc = float((pc - pc_want).abs().max())
        log(f"round 1's compact tables: G={g_all} C={gt.m.shape[1]} U={gt.m.shape[2]}, "
            f"{int(r['gvalid'].sum())} exchanged pairs of {cnt.shape[0]} rows, bucket "
            f"capacity {r['cap']} ({bucket_bytes(r['cap'], world)} bytes); merge_gain "
            f"against the plain version on the card (all groups): max abs err "
            f"{err_card:.3g}, on CPU copies (1024 groups): {err_cpu:.3g}; pair_cost against "
            f"the plain version on the card: max abs err {err_pc:.3g}")
        for k, e in (("merge_gain", max(err_card, err_cpu)), ("pair_cost", err_pc)):
            if k in smoke.kernels and "max_abs_err" in smoke.kernels[k]:
                smoke.kernels[k]["max_abs_err"] = max(smoke.kernels[k]["max_abs_err"], e)
        del got, gt, r

        # where a compact round's time goes: round 1 replayed stage by stage
        stages: dict[str, float] = {}
        for _ in range(2):  # the second pass is kept (allocator warm)
            torch.cuda.synchronize()
            t_last = [time.perf_counter()]

            def mark(name):
                torch.cuda.synchronize()
                now = time.perf_counter()
                stages[name] = (now - t_last[0]) * 1e3
                t_last[0] = now

            be.compact_tables(sh.src, sh.dst, state, mark=mark)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            be.step(sh.src, sh.dst, state, 0.5, 1)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
        rest = step_ms - sum(stages.values())
        log(f"compact round 1 stages (ms, synchronized): " + ", ".join(
            f"{k} {x:.1f}" for k, x in stages.items()) + f"; merge_gain, matching, gathers, "
            f"merge and metrics {rest:.1f} (the step's {step_ms:.1f} less the stages)")

        # a small case: the card at a world of one against 2 gloo ranks on the
        # CPU, both drawing the CPU generator's permutations (the launcher's
        # on the CPU; a CUDA generator draws others)
        from repro_torch.core.shingles import SeededPermutations
        from repro_torch.graphs.feed import shard_edges

        small = ["--dataset", "ego-facebook", "--scale", "0.05", "--T", "10",
                 "--k-frac", "0.3", "--distributed"]
        src_s, dst_s, v_s = generate("ego-facebook", seed=0, scale=0.05)
        g_s, _ = make_graph(src_s, dst_s, v_s, "cpu")
        sh_s = shard_edges(g_s.src.numpy(), g_s.dst.numpy(), rank, world, dev)
        cfg_s = SummaryConfig(T=10, k_frac=0.3)
        pipe = launch.build_distributed_pipeline(cfg_s, v_s, sh_s.num_edges, dev,
                                                 perms=SeededPermutations(cfg_s.seed, "cpu"))
        _, stats_s, _, run_s = launch.run_distributed(sh_s, v_s, cfg_s, dev, pipe)
        card = dict(stats_s, history=run_s.history, iterations=run_s.iterations_run)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "repro_torch.launch.summarize", *small,
             "--device", "cpu"], capture_output=True, text=True, timeout=300, env=env,
            cwd=ROOT)
        if proc.returncode != 0:
            raise RuntimeError(f"the 2-rank gloo run failed:\n{proc.stdout}\n{proc.stderr}")
        cpu = json.loads(proc.stdout[proc.stdout.index("digests"):].split("\n", 1)[1])
        keys = ("nmerges", "num_supernodes", "num_superedges")
        parted = [i + 1 for i, (a, b) in enumerate(zip(card["history"], cpu["history"]))
                  if any(a[k] != b[k] for k in keys)]
        log(f"ego-facebook 0.05, T=10: card (world 1, NCCL) size_bits {card['size_bits']}, "
            f"supernodes {card['num_supernodes']}, {card['iterations']} rounds; CPU (2 gloo "
            f"ranks) size_bits {cpu['size_bits']}, supernodes {cpu['num_supernodes']}, "
            f"{cpu['iterations']} rounds; first round whose integer stats part: "
            f"{parted[0] if parted else None}")
        if (parted and parted[0] == 1) or not np.isclose(
                card["history"][0]["size_bits"], cpu["history"][0]["size_bits"], rtol=RTOL):
            errors.append("card and CPU part in round 1")
        if not parted and (card["num_supernodes"] != cpu["num_supernodes"] or not np.isclose(
                card["size_bits"], cpu["size_bits"], rtol=RTOL)):
            errors.append("card and CPU agree round by round but not at the end")
        tdist.destroy_process_group()
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("9 edge-sharded", phase_distributed)

    # ---- 10. the multi-rank query tiers --------------------------------------
    def phase_query_tiers():
        from repro_torch.core.query_engine import (KIND_NAMES, SET_KINDS,
                                                   PartitionedQueryEngine, QueryEngine,
                                                   RoutedQueryEngine, build_partition_tables,
                                                   pack_set_counts)
        from repro_torch.core.queries import row_entries
        from repro_torch.dist import owner_hash
        from repro_torch.kernels.segment_sum import segment_sum_cuda
        from repro_torch.launch.query_serve import random_workload

        card = nvidia_smi("name,power.limit")
        errors = []
        local_out = ctx["serve_out"]

        # (a) the launcher's two tiers at a world of one over NCCL, phase 7's stream
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        for tier in ("replicated", "partitioned"):
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.query_serve", "--edge-list",
                 ctx["edge_list"], "--T", "20", "--k-frac", "0.3", "--requests",
                 str(SERVE_REQUESTS), "--batch", str(SERVE_SLOTS), "--queries", ALL_KINDS,
                 "--device", "cuda", "--distributed", "--tier", tier],
                capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
            if proc.returncode != 0:
                raise RuntimeError(f"--tier {tier} failed:\n{proc.stdout}\n{proc.stderr}")
            out = json.loads(proc.stdout[proc.stdout.index("{\n"):])
            counts = out["kernel_launches"]
            log(f"[{card}] --distributed --tier {tier}: mode {out['mode']} ({out['backend']}), "
                f"QPS {out['qps']:.1f}, p50 {out['p50_latency_s'] * 1e3:.2f} ms, p99 "
                f"{out['p99_latency_s'] * 1e3:.2f} ms (phase 7: QPS {local_out['qps']:.1f}, "
                f"p50 {local_out['p50_latency_s'] * 1e3:.2f} ms, p99 "
                f"{local_out['p99_latency_s'] * 1e3:.2f} ms); engine build "
                f"{out['engine_build_wall_s']:.3f} s (phase 7: "
                f"{local_out['engine_build_wall_s']:.3f} s), its device peak "
                f"{out['engine_build_peak_bytes']} bytes above what was held (phase 7: "
                f"{local_out['engine_build_peak_bytes']}); owner counts {out['owner_counts']}"
                + (f"; partition {out['partition_stats']}" if tier == "partitioned" else "")
                + f"; digest {out['answers_digest']}; launches {counts}")
            if out["answers_digest"] != local_out["answers_digest"]:
                errors.append(f"--tier {tier}: digest {out['answers_digest']} != phase 7's "
                              f"{local_out['answers_digest']}")
            n = out["iterations"]
            if (counts["merge_gain"] != n or counts["pair_cost"] != n
                    or counts["segment_sum"] == 0 or counts["ordered_sum"] == 0):
                errors.append(f"--tier {tier}: launches {counts} ({n} rounds)")
            for k in counts:
                smoke.kernels.setdefault(k, {}).setdefault("launches_by_path", {})[
                    f"query tier {tier}"] = counts[k]

        # (b) P = 4 on phase 4's summary, every rank's row work in turn here
        res = ctx["res"]
        local = QueryEngine(res, device="cuda")
        bs = local.bs
        for p in (4, 8):
            for dn in (None, 32):
                t = build_partition_tables(bs, owner_hash(bs.ids, 0, p), p, dn)
                errors += partition_coverage(bs, t, p)
        kinds_all = [KIND_NAMES[k] for k in ALL_KINDS.split(",")]
        reqs = random_workload(np.random.default_rng(0), ctx["v"], SERVE_SLOTS * len(kinds_all),
                               kinds_all)
        batches = {}
        for name, k in KIND_NAMES.items():
            batch = [r for r in reqs if r.kind == k][:SERVE_SLOTS]
            kinds = np.full(len(batch), k, np.int32)
            sets = (None, None, None)
            if k in SET_KINDS:
                sets = pack_set_counts(bs, kinds, [r.a for r in batch], [r.b for r in batch])
            batches[name] = (kinds, np.array([r.u for r in batch]), np.array([r.v for r in batch]),
                             *sets)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        pr_want, tri_want = local.pagerank_blocks(), local.triangle_density()
        want = {k: local.answer_batch(*b) for k, b in batches.items()}
        torch.cuda.synchronize()
        local_counts = ops.launch_counts()
        tier_counts = {}
        for label, make in (
                ("routed", lambda: RoutedQueryEngine(res, device="cuda", ranks=4)),
                ("partitioned", lambda: PartitionedQueryEngine(res, device="cuda", ranks=4)),
                ("partitioned, dense_row_nnz 32", lambda: PartitionedQueryEngine(
                    res, device="cuda", ranks=4, dense_row_nnz=32))):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = make()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            build_peak = torch.cuda.max_memory_allocated() - held
            pr = eng.pagerank_blocks()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            tri = eng.triangle_density()
            t3 = time.perf_counter()
            same = {"PageRank blocks": torch.equal(pr, pr_want)
                    and eng.pagerank_iterations == local.pagerank_iterations,
                    "triangle total": tri == tri_want
                    and eng.triangle_wedges == local.triangle_wedges}
            same.update({k: np.array_equal(eng.answer_batch(*b), want[k])
                         for k, b in batches.items()})
            torch.cuda.synchronize()
            tier_counts[label] = ops.launch_counts()
            extra = ""
            if hasattr(eng, "partition_stats"):
                st = eng.partition_stats()
                extra = (f"; build's device peak {build_peak} bytes above what was held, "
                         f"for all 4 ranks; halo per rank {st['halo_counts']} (row halo max "
                         f"{st['row_halo_max']}), dense rows {st['dense_rows']}, owner counts "
                         f"{st['owner_counts']}, resident bytes per rank "
                         f"{st['resident_bytes_per_device']} against "
                         f"{st['replicated_row_bytes']} replicated")
                if max(st["resident_bytes_per_device"]) >= st["replicated_row_bytes"]:
                    errors.append(f"{label}: a rank holds as many row bytes as the whole CSR")
            log(f"[{card}] P = 4 in one process, {label}: build {(t1 - t0) * 1e3:.1f} ms, "
                f"PageRank {(t2 - t1) * 1e3:.1f} ms ({eng.pagerank_iterations} steps), "
                f"triangles {(t3 - t2) * 1e3:.1f} ms ({eng.triangle_wedges} wedges); equal to "
                f"the single-device engine's bits: {same}; launches "
                f"{tier_counts[label]}{extra}")
            if not all(same.values()):
                errors.append(f"{label} at P = 4 differs from the single-device engine: {same}")
            for k in ("segment_sum", "ordered_sum"):
                if tier_counts[label][k] == 0:
                    errors.append(f"{label} at P = 4 never launched {k}")
            del eng
        log(f"single-device engine on the same work: launches {local_counts}")
        for k in ("segment_sum", "ordered_sum"):
            smoke.kernels[k]["launches_by_path"]["query tiers, P = 4 in one process"] = sum(
                c[k] for c in tier_counts.values())

        # (c) the kernel over one rank's rows gives those rows of the full launch
        share = torch.rand(bs.num_blocks, dtype=torch.float64, device=dev)
        vals = bs.deg_w * share[bs.cols]
        full = segment_sum_cuda(bs.indptr, vals, bs.long_rows)
        owner = owner_hash(bs.ids, 0, 4)
        for q in range(4):
            rows = torch.nonzero(owner == q).squeeze(1)
            sub, ent, _ = row_entries(bs.indptr, rows)
            if not torch.equal(segment_sum_cuda(sub, vals[ent].contiguous()), full[rows]):
                errors.append(f"segment_sum over rank {q}'s rows differs from the full launch")
        log("segment_sum over each of 4 ranks' rows equals those rows of one launch over "
            f"all {bs.num_blocks} rows: {not any('segment_sum over' in e for e in errors)}")
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("10 query tiers", phase_query_tiers)

    # ---- 11. multi-host: the bootstrap, the codecs, the four-leg gate --------
    def phase_multihost():
        import contextlib
        import io

        import torch.distributed as tdist
        from repro_torch.core.query_engine import RankSet
        from repro_torch.dist.compress import (CompressConfig, compressed_all_reduce,
                                               encode_int8, encode_topk, payload_bytes)
        from repro_torch.graphs import write_edge_list
        from repro_torch.launch import summarize as launch

        card = nvidia_smi("name,power.limit")
        errors = []

        # (a) the launcher through the bootstrap's flags at a world of one
        if "dist_run" not in ctx:
            raise AssertionError("phase 9's run is not at hand")
        out9, dig9 = ctx["dist_run"]
        args = ["--edge-list", ctx["edge_list"], "--T", "20", "--k-frac", "0.3",
                "--distributed", "--device", "cuda", "--coordinator",
                f"localhost:{free_port()}", "--num-processes", "1", "--process-id", "0"]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = launch.main(args)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        dig = [ln for ln in buf.getvalue().splitlines() if ln.startswith("digests")][0]
        med = np.median([h["round_s"] * 1e3 for h in out["history"]])
        med9 = np.median([h["round_s"] * 1e3 for h in out9["history"]])
        differ = [k for k in MULTIHOST_EXACT_KEYS if out[k] != out9[k]]
        log(f"[{card}] --distributed --coordinator ... --num-processes 1: mode {out['mode']} "
            f"({out['backend']}, {out['device']}), {out['iterations']} rounds, size_bits "
            f"{out['size_bits']}, supernodes {out['num_supernodes']}, feed {out['feed_path']}, "
            f"process {out['process_index']} of {out['process_count']}; median round "
            f"{med:.1f} ms (phase 9: {med9:.1f} ms); summarize wall {out['wall_s']:.2f} s; "
            f"exact keys differing from phase 9: {differ}; digests equal: {dig == dig9}; "
            f"launches {counts}")
        if differ or dig != dig9:
            errors.append(f"the bootstrapped launcher differs from phase 9: {differ}, "
                          f"digests equal {dig == dig9}")
        n = out["iterations"]
        if counts != {"merge_gain": n, "pair_cost": n, "segment_sum": 0, "ordered_sum": 0}:
            errors.append(f"launch counts {counts} != one of each per round ({n} rounds)")
        for k in counts:
            smoke.kernels.setdefault(k, {}).setdefault("launches_by_path", {})[
                "multi-host"] = counts[k]

        # (b) the codecs on the card: a world of one over NCCL, and P = 4 ranks
        # in this process; the wire check's shapes and one 2^24-element payload
        launch.init_distributed(dev)
        gen = torch.Generator(device=dev).manual_seed(11)
        shapes = dict(WIRE_SHAPES, big=(1 << 24,))

        def tree_of():
            return {k: torch.randn(shp, generator=gen, device=dev) for k, shp in shapes.items()}

        for label, ranks, trees in (("NCCL world of one", RankSet(dev), [tree_of()]),
                                    ("P = 4 in one process", RankSet(dev, ranks=4),
                                     [tree_of() for _ in range(4)])):
            p = ranks.size
            one = p == 1
            cpu = [{k: x.cpu() for k, x in t.items()} for t in trees]
            errs = [{k: torch.zeros_like(x, dtype=torch.float32) for k, x in t.items()}
                    for t in trees]
            line = []
            for kind in ("none", "int8", "topk"):
                cfg = CompressConfig(kind, topk_ratio=0.1)
                summed, new_err, wire = compressed_all_reduce(
                    trees[0] if one else trees, errs[0] if one else errs, cfg, ranks)
                priced = p * payload_bytes(trees[0], cfg)
                if wire != priced:
                    errors.append(f"{label} {kind}: measured {wire} bytes, priced {priced}")
                if kind == "none":
                    parts = cpu
                elif kind == "int8":
                    parts = []
                    for c in cpu:
                        q, sc = encode_int8(c)
                        parts.append({k: q[k].double() * sc[k].double() for k in c})
                else:
                    parts = []
                    got_err = [new_err] if one else new_err
                    for r, c in enumerate(cpu):
                        sent, res = encode_topk(c, None, 0.1)
                        parts.append(sent)
                        for k in c:
                            if not torch.equal(sent[k] + res[k], c[k]):
                                errors.append(f"{label} topk rank {r} {k}: sent + residual "
                                              "!= acc")
                            if not torch.equal(got_err[r][k].cpu(), res[k]):
                                errors.append(f"{label} topk rank {r} {k}: the residual is "
                                              "not this rank's own")
                for k in shapes:
                    want = sum(x[k].double() for x in parts).numpy()
                    if not np.allclose(summed[k].cpu().double().numpy(), want, rtol=RTOL,
                                       atol=1e-5 if kind == "none" else 1e-6):
                        errors.append(f"{label} {kind} {k}: the sum differs from the CPU's "
                                      "float64 sum")
                big = [t["big"] for t in trees]
                nbytes = big[0].numel() * 4
                if one:
                    t_ar = time_single(torch, lambda: compressed_all_reduce(
                        {"big": big[0]}, {"big": errs[0]["big"]}, cfg, ranks), reps=5)
                else:
                    t_ar = time_single(torch, lambda: compressed_all_reduce(
                        [{"big": b} for b in big], [{"big": e["big"]} for e in errs], cfg,
                        ranks), reps=5)
                # the least bytes the all-reduce must move: every rank's payload
                # read once and the sum written once
                ar_bound = (p + 1) * nbytes / HBM_BYTES_PER_S * 1e3
                line.append(f"{kind} {t_ar:.3f} ms (bound {ar_bound:.3f}, wire {wire} B)")
            t_int8 = time_cuda(torch, lambda: encode_int8({"big": big[0]}), launches=10)
            t_topk = time_cuda(torch, lambda: encode_topk({"big": big[0]}, None, 0.1),
                               launches=5)
            # int8: read 4 B, write 1 B an element; top-k: read 4 B, write the
            # dense sent and the residual, 4 B each
            log(f"[{card}] codecs, {label}, payload 2^24 float32 ({nbytes} B): all-reduce "
                f"(one call, CUDA events, the wire-byte read-back inside) "
                + "; ".join(line) + f"; encode_int8 {t_int8:.4f} ms (bound "
                f"{5 * big[0].numel() / HBM_BYTES_PER_S * 1e3:.4f}), encode_topk "
                f"{t_topk:.4f} ms (bound {12 * big[0].numel() / HBM_BYTES_PER_S * 1e3:.4f})")
            del trees, cpu, errs
        tdist.destroy_process_group()

        # (c) the four-leg gate over gloo on this host's CPU, 2 processes
        path = os.path.join(ctx["tmp"], "ego-facebook-0.05.txt")
        src_s, dst_s, v_s = generate("ego-facebook", seed=0, scale=0.05)
        write_edge_list(path, src_s, dst_s, v_s)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tests", "torch_multihost_check.py"),
             "--edge-list", path, "--T", "5", "--num-processes", "2", "--device", "cpu",
             "--workdir", os.path.join(ctx["tmp"], "multihost"), "--timeout", "240"],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        if proc.returncode != 0:
            raise RuntimeError(f"torch_multihost_check failed:\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-4000:]}")
        rep = json.loads(proc.stdout[proc.stdout.index("{"):])
        mh = rep["legs"]["multihost"]["procs"]
        log(f"torch_multihost_check, 2 gloo processes on the host's CPU, ego-facebook 0.05, "
            f"T=5: ok {rep['ok']}; legs' walls (host time, s) "
            + ", ".join(f"{k} {w:.1f}" for k, w in rep["walls"].items())
            + f"; golden size_bits {rep['legs']['golden']['size_bits']}; resume from step "
            f"{rep['legs']['resume'].get('resume_from')}; feed a process: "
            + ", ".join(f"{p['feed_path']} {p['feed_shard_rows']} rows, "
                        f"{p['feed_bytes_copied']} B copied" for p in mh))
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("11 multi-host", phase_multihost)

    # ---- 12. the baselines on the card ---------------------------------------
    def phase_baselines():
        from repro_torch.baselines import (evaluate_partition, summarize_kgs, summarize_s2l,
                                           summarize_saa_gs)
        from repro_torch.baselines import s2l as s2l_lib
        errors = []
        # (a) phase 4's full-size partition, evaluated on the card and the CPU
        src, dst, v = ctx["src"], ctx["dst"], ctx["v"]
        n2s = ctx["res_arrays"]["node2super"]
        walls, got = [], None
        for _ in range(2):  # the second call is the warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = evaluate_partition(src, dst, v, n2s, "ssumm", device="cuda")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = evaluate_partition(src, dst, v, n2s, "ssumm", device="cpu")
        cpu_s = time.perf_counter() - t0
        rel = {k: abs(getattr(got, k) - getattr(want, k)) / max(abs(getattr(want, k)), 1e-300)
               for k in ("size_bits", "input_size_bits", "re1", "re2")}
        log(f"12a evaluate_partition, phase 4's partition (V={v}, E={len(src)}): card "
            f"{walls[0] * 1e3:.1f} ms (host-to-card copies included), warm "
            f"{walls[1] * 1e3:.1f} ms; CPU {cpu_s * 1e3:.1f} ms; supernodes "
            f"{got.num_supernodes}, superedges (all nonzero pairs) {got.num_superedges}, "
            f"re1 {got.re1!r}, re2 {got.re2!r}, size_bits {got.size_bits!r}; relative "
            f"differences card vs CPU {rel}")
        if (got.num_supernodes, got.num_superedges) != (want.num_supernodes,
                                                        want.num_superedges):
            errors.append("12a: card and CPU counts differ")
        if not torch.equal(got.node2super.cpu(), want.node2super):
            errors.append("12a: node2super differs")
        if max(rel.values()) > 1e-12:
            errors.append(f"12a: floats beyond rtol 1e-12: {rel}")

        # (b) S2L at email-enron's full size on the card, once (its seeding is
        # 98% of a run's 25-28 s; run-to-run identity is held in (c))
        src2, dst2, v2 = generate("email-enron", seed=0, scale=1.0)
        k2 = max(int(0.3 * v2), 2)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = summarize_s2l(src2, dst2, v2, target_frac=0.3, seed=0, device="cuda", stats=st)
        torch.cuda.synchronize()
        w, pk = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
        rows = max(1, s2l_lib.ASSIGN_BYTES // (4 * k2))
        log(f"12b S2L email-enron V={v2} E={len(src2)} k={k2} dims=32: wall "
            f"{w:.2f} s, seeding {st['seed_s']:.2f} s, Lloyd {st['lloyd_iters']} "
            f"iterations in {st['lloyd_s']:.3f} s "
            f"({st['lloyd_s'] / max(st['lloyd_iters'], 1) * 1e3:.2f} ms an iteration), "
            f"peak {pk / 2**20:.1f} MiB; supernodes {r.num_supernodes}, re1 {r.re1!r}, "
            f"relative size {r.size_bits / r.input_size_bits!r}")
        log(f"12b chunk budget {s2l_lib.ASSIGN_BYTES} bytes a [rows, k] block: {rows} rows a "
            f"chunk, {-(-v2 // rows)} chunks")

        # (c) the same S2L at scale 0.25, card against CPU, each Lloyd step
        # recorded; then the card again, equal to its first run bit for bit
        src3, dst3, v3 = generate("email-enron", seed=0, scale=0.25)
        inner, calls = s2l_lib._assign, {"cpu": [], "cuda": []}
        out3 = {}
        try:
            for d in ("cpu", "cuda"):
                def spy(x, c, *rest, _d=d):
                    lab = inner(x, c, *rest)
                    calls[_d].append((c.cpu(), lab.cpu()))
                    return lab
                s2l_lib._assign = spy
                t0 = time.perf_counter()
                out3[d] = (summarize_s2l(src3, dst3, v3, target_frac=0.3, seed=0, device=d),
                           time.perf_counter() - t0)
        finally:
            s2l_lib._assign = inner
        (rc, wc), (rg, wg) = out3["cpu"], out3["cuda"]
        lab_c, lab_g = rc.node2super, rg.node2super.cpu()
        share = float((lab_c == lab_g).double().mean())
        first = next((i for i, (a, b) in enumerate(zip(calls["cpu"], calls["cuda"]))
                      if not torch.equal(a[1], b[1])), None)
        gap = "none (every assignment equal)"
        if first is not None:
            (c_c, a_c), (c_g, a_g) = calls["cpu"][first], calls["cuda"][first]
            x3 = s2l_lib.project_rows(src3, dst3, v3, max(int(np.ceil(np.log2(v3))) * 2, 8), 0)
            row = int(torch.nonzero(a_c != a_g)[0])
            dist = [float(((x3[row].astype(np.float64) - c_c[j].double().numpy()) ** 2).sum())
                    for j in (int(a_c[row]), int(a_g[row]))]
            gap = (f"assignment {first} (centers equal: {torch.equal(c_c, c_g)}), "
                   f"{int((a_c != a_g).sum())} rows differ; row {row}: float64 distances "
                   f"{dist[0]!r} (CPU's label) and {dist[1]!r} (card's), relative gap "
                   f"{abs(dist[0] - dist[1]) / max(dist):.3g}")
        rel3 = {k: abs(getattr(rg, k) - getattr(rc, k)) / abs(getattr(rc, k))
                for k in ("re1", "size_bits")}
        log(f"12c S2L email-enron scale 0.25 (V={v3}), card against CPU: labels equal "
            f"{share:.6f}; {len(calls['cpu'])} and {len(calls['cuda'])} assignments; first "
            f"difference: {gap}; re1 CPU {rc.re1!r} card {rg.re1!r}, size_bits CPU "
            f"{rc.size_bits!r} card {rg.size_bits!r}, relative differences {rel3}; walls CPU "
            f"{wc:.2f} s, card {wg:.2f} s")
        if max(rel3.values()) > 0.01:
            errors.append(f"12c: RE1 or size beyond 1% of the CPU's: {rel3}")
        rg2 = summarize_s2l(src3, dst3, v3, target_frac=0.3, seed=0, device="cuda")
        same = torch.equal(rg.node2super, rg2.node2super) and all(
            getattr(rg, k) == getattr(rg2, k) for k in ("size_bits", "re1", "re2",
                                                         "num_supernodes", "num_superedges"))
        log(f"12c two card runs at scale 0.25 equal bit for bit: {same}")
        if not same:
            errors.append("12c: two card runs of S2L differ")

        # (d) the paper's Fig. 4 point: SSumM against k-Gs and SAA-Gs at equal size
        src4, dst4, v4 = generate("ego-facebook", seed=1, scale=0.1)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ss = summarize(src4, dst4, v4, SummaryConfig(T=10, k_frac=0.3, seed=1), device="cuda")
        torch.cuda.synchronize()
        ss_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        ctx["baseline_counts"] = counts
        kg = summarize_kgs(src4, dst4, v4, target_frac=0.3, seed=1, device="cuda")
        sa = summarize_saa_gs(src4, dst4, v4, target_frac=0.3, seed=1, device="cuda")
        for name, r, w in (("SSumM", ss, ss_s), ("k-Gs", kg, kg.wall_s),
                           ("SAA-Gs", sa, sa.wall_s)):
            log(f"12d {name}: relative size {r.size_bits / r.input_size_bits!r}, "
                f"re1 {r.re1!r}, re2 {r.re2!r}, supernodes {r.num_supernodes}, wall {w:.3f} s")
        log(f"12d SSumM launches {counts} over {ss.iterations_run} rounds")
        if not ss.size_bits <= max(kg.size_bits, sa.size_bits):
            errors.append("12d: SSumM's size exceeds both baselines'")
        if not ss.re1 <= sa.re1 * 1.1:
            errors.append("12d: SSumM's RE1 is above 1.1x SAA-Gs'")
        if counts["merge_gain"] != ss.iterations_run or counts["pair_cost"] != ss.iterations_run:
            errors.append(f"12d: launch counts {counts} != one per round")
        for k in ("merge_gain", "pair_cost"):
            smoke.kernels.setdefault(k, {}).setdefault("launches_by_path", {})[
                "baselines comparison, SSumM side"] = counts[k]
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("12 baselines", phase_baselines)

    # ---- 13. LM serving at qwen2.5-14B's full width --------------------------
    def phase_lm():
        from repro_torch.configs import get_config
        from repro_torch.models.api import build_model
        from repro_torch.models.common import param_bytes
        from repro_torch.models.transformer import kv_cache_bytes
        errors = []
        full = get_config("qwen2_5_14b")
        # (a) numerics: full width, 2 layers, float32, TF32 off
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
        b, n = 2, 16
        tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (b, n)),
                                 device=dev)
        model, params, fwd, text, errs = card_vs_cpu(torch, cfg, {"tokens": tokens}, tol=1e-3,
                                                     dec_tol=1e-3)
        log(f"13a qwen2.5-14B full width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), 2 layers, float32, TF32 off, "
            f"tokens [{b}, {n}]: {text}")
        errors += [f"13a: {e}" for e in errs]
        del model, params, fwd
        torch.cuda.empty_cache()

        # (b) service: 12 of the 48 layers at full width, bfloat16, through
        # BatchServer (the depth cut to keep the script inside its time limit)
        full = dataclasses.replace(full, n_layers=12)
        slots, max_len, prompt_len, gen_len, nreq = 8, 128, 32, 32, 8
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = build_model(full, "cuda")
        params = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pbytes = param_bytes(params)
        kv = kv_cache_bytes(full, slots, max_len)
        bound_ms = (pbytes + kv) / HBM_BYTES_PER_S * 1e3
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, full.vocab, prompt_len).astype(np.int32) for _ in range(nreq)]

        runs = serve_twice(full, params, prompts, slots=slots, max_len=max_len,
                           gen_len=gen_len)
        (s0, out0, _), (s1, out1, _) = runs
        line, med, ntok = service_line(runs)
        peak = torch.cuda.max_memory_allocated()
        log(f"13b qwen2.5-14B, {full.n_layers} layers, bfloat16: {pbytes} parameter bytes initialised on "
            f"the card in {init_s:.2f} s; {nreq} requests, {slots} slots, prompt {prompt_len}, "
            f"gen {gen_len}, max_len {max_len}: {line}; peak {peak / 2**30:.2f} GiB; step "
            f"bound {bound_ms:.3f} ms (parameters {pbytes} + KV cache {kv} bytes at 3.35 TB/s), "
            f"{100 * bound_ms / med:.1f}% of it")
        # device busy share of three decode steps, under torch.profiler
        profile_decode(torch, model, params, {
            "token": torch.zeros(slots, dtype=torch.int64, device=dev),
            "pos": torch.arange(slots, device=dev), "cache": s0.cache}, "13b")
        log(f"13b the two runs' tokens equal: {out0 == out1}")
        if out0 != out1:
            errors.append("13b: two runs' tokens differ")
        if ntok != nreq * gen_len:
            errors.append(f"13b: {ntok} tokens, not {nreq * gen_len}")
        del model, params, runs, s0, s1
        torch.cuda.empty_cache()
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("13 LM serving", phase_lm)

    # ---- 14. the MoE family's serving path -----------------------------------
    def phase_moe():
        from repro_torch.configs import get_config
        from repro_torch.models import moe as moe_lib
        from repro_torch.models.api import build_model
        from repro_torch.models.common import param_bytes, tree_to
        from repro_torch.models.transformer import kv_cache_bytes
        errors = []
        # (a) numerics: moonshot-v1-16b-a3b at full width, 2 layers, float32,
        # TF32 off, capacity factor 16 (the forward drops nothing, as decode)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        full = get_config("moonshot_v1_16b_a3b")
        cfg = dataclasses.replace(full, n_layers=2, dtype="float32",
                                  moe=dataclasses.replace(full.moe, capacity_factor=16.0))
        model = build_model(cfg, "cuda")
        params = model.init(0)
        pbytes_a = param_bytes(params)
        b, n = 2, 16
        tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (b, n)),
                                 device=dev)
        with MoeRecorder(moe_lib) as rec_card:
            fwd, aux_card = model.forward(params, {"tokens": tokens})
        cpu_params = tree_to(params, "cpu")
        with MoeRecorder(moe_lib) as rec_cpu:
            want, aux_cpu = build_model(cfg, "cpu").forward(cpu_params, {"tokens": tokens.cpu()})
        got = fwd.cpu()
        fwd_err = float((got - want).abs().max())
        fwd_ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3)
        cache = model.init_cache(b, n)
        dec_err, dec_ok = 0.0, True
        with MoeRecorder(moe_lib) as rec_dec:
            for t in range(n):
                lg, cache = model.serve_step(params, {"token": tokens[:, t],
                                                      "pos": torch.tensor(t), "cache": cache})
                dec_err = max(dec_err, float((lg - fwd[:, t]).abs().max()))
                dec_ok &= torch.allclose(lg, fwd[:, t], rtol=1e-3, atol=1e-3)
        drops = {"card": rec_card.drop_fracs(), "CPU": rec_cpu.drop_fracs(),
                 "decode": rec_dec.drop_fracs()}
        log(f"14a moonshot-v1-16b-a3b full width (d_model {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.moe.num_experts} "
            f"experts top-{cfg.moe.top_k}), 2 layers, float32, TF32 off, capacity factor 16, "
            f"{pbytes_a} parameter bytes, tokens [{b}, {n}]: forward card vs CPU max abs diff "
            f"{fwd_err:.3g} (|logits| max {float(want.abs().max()):.3g}); decode vs forward on "
            f"the card max abs diff {dec_err:.3g}; both held to rtol 1e-3, atol 1e-3; moe_aux "
            f"card {float(aux_card['moe_aux']):.6g}, CPU {float(aux_cpu['moe_aux']):.6g}; drop "
            f"fractions forward card {drops['card']}, CPU {drops['CPU']}, decode max "
            f"{max(drops['decode'])}")
        if not fwd_ok:
            errors.append("14a: forward logits card vs CPU beyond tolerance")
        if not dec_ok:
            errors.append("14a: decode logits vs forward beyond tolerance")
        if any(f != 0.0 for v in drops.values() for f in v):
            errors.append(f"14a: records dropped at capacity factor 16: {drops}")
        del model, params, cpu_params, fwd, want, got, cache, rec_card, rec_cpu, rec_dec
        torch.cuda.empty_cache()

        # (b) service: granite-moe-3b-a800m, 8 of its 32 bfloat16 layers (the
        # depth cut for the time limit), through BatchServer
        full = get_config("granite_moe_3b_a800m")
        served = dataclasses.replace(full, n_layers=8)
        slots, max_len, prompt_len, gen_len, nreq = 8, 128, 32, 32, 8
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = build_model(served, "cuda")
        params = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pbytes = param_bytes(params)
        kv = kv_cache_bytes(served, slots, max_len)
        bound_ms = (pbytes + kv) / HBM_BYTES_PER_S * 1e3
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, full.vocab, prompt_len).astype(np.int32) for _ in range(nreq)]

        ops.reset_launch_counts()
        runs = serve_twice(served, params, prompts, slots=slots, max_len=max_len,
                           gen_len=gen_len)
        ctx["moe_counts"] = ops.launch_counts()
        (s0, out0, _), (s1, out1, _) = runs
        line, med, ntok = service_line(runs)
        peak = torch.cuda.max_memory_allocated()
        # one steady decode step of the 8 requests (their last tokens, the
        # cache of run 1) recorded: the experts it routes to, layer by layer
        tok = torch.as_tensor([out0[r][-1] for r in range(nreq)], dtype=torch.int64,
                              device=dev)
        pos = torch.full((slots,), prompt_len + gen_len - 1, dtype=torch.int64, device=dev)
        cache = s0.cache
        d, f = full.d_model, full.d_ff
        expert_bytes = 3 * d * f * 2  # wi, wg, wo of one expert, bfloat16
        e_pad = full.moe.experts_padded(moe_lib.EP)
        with MoeRecorder(moe_lib) as rec:
            model.serve_step(params, {"token": tok, "pos": pos, "cache": cache})
        used = [int(torch.unique(moe_lib.route(c["p"]["router"], c["x"].reshape(-1, d),
                                               full.moe.num_experts, full.moe.top_k)[2]).numel())
                for c in rec.calls]
        routed = pbytes - served.n_layers * e_pad * expert_bytes + sum(used) * expert_bytes
        routed_ms = (routed + kv) / HBM_BYTES_PER_S * 1e3
        log(f"14b granite-moe-3b-a800m, {served.n_layers} of {full.n_layers} layers, bfloat16 "
            f"({e_pad} padded experts, float32 routers and norms): {pbytes} parameter bytes "
            f"initialised on the card in "
            f"{init_s:.2f} s; {nreq} requests, {slots} slots, prompt {prompt_len}, gen {gen_len}, "
            f"max_len {max_len}: {line}; "
            f"peak {peak / 2**30:.2f} GiB; step bound {bound_ms:.3f} ms (parameters {pbytes} + "
            f"KV cache {kv} bytes at 3.35 TB/s; every expert's bucket is multiplied), "
            f"{100 * bound_ms / med:.1f}% of it; a steady step routes to {min(used)}-"
            f"{max(used)} of {full.moe.num_experts} experts a layer ({sum(used)} in all): "
            f"{routed} bytes with the KV cache {routed + kv}, {routed_ms:.3f} ms at 3.35 TB/s; "
            f"launches of the hand kernels over both runs {ctx['moe_counts']}")
        # device busy share of three decode steps, under torch.profiler
        profile_decode(torch, model, params, {"token": tok, "pos": pos, "cache": cache}, "14b")
        log(f"14b the two runs' tokens equal: {out0 == out1}")
        if out0 != out1:
            errors.append("14b: two runs' tokens differ")
        if ntok != nreq * gen_len:
            errors.append(f"14b: {ntok} tokens, not {nreq * gen_len}")
        del model, params, runs, s0, s1, cache, rec
        torch.cuda.empty_cache()

        # (c) determinism of the block: granite's MoE at full width, float32,
        # a prefill-shaped input at the default capacity factor (records dropped)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        p = moe_lib.init_moe(gen, full, torch.float32, dev)
        x = (torch.randn((8, 128, d), generator=gen, device=dev)
             + torch.randn((d,), generator=gen, device=dev))  # one shared direction
        y1, aux1 = moe_lib.apply_moe(p, x, full)
        y2, aux2 = moe_lib.apply_moe(p, x, full)
        same_bits = torch.equal(y1.view(torch.int32), y2.view(torch.int32))
        block_ms = time_cuda(torch, lambda: moe_lib.apply_moe(p, x, full), launches=5, batches=3)
        p_cpu = tree_to(p, "cpu")
        y_cpu, aux_cpu = moe_lib.apply_moe(p_cpu, x.cpu(), full)
        e_card = moe_lib.route(p["router"], x.reshape(-1, d), full.moe.num_experts,
                               full.moe.top_k)[2].cpu()
        e_cpu = moe_lib.route(p_cpu["router"], x.cpu().reshape(-1, d), full.moe.num_experts,
                              full.moe.top_k)[2]
        n_tok = x.shape[0] * x.shape[1]
        cap = max(int(full.moe.top_k * n_tok * full.moe.capacity_factor / full.moe.num_experts), 1)
        log(f"14c granite's MoE block at full width, float32, x {list(x.shape)}, capacity factor "
            f"{full.moe.capacity_factor} (capacity {cap}): two card runs bit-identical "
            f"{same_bits}; drop fraction card {float(aux1['moe_drop_frac']):.6g}, CPU "
            f"{float(aux_cpu['moe_drop_frac']):.6g}; max abs diff against CPU copies "
            f"{float((y1.cpu() - y_cpu).abs().max()):.3g} (|y| max "
            f"{float(y_cpu.abs().max()):.3g}); tokens routed to the same experts "
            f"{int((e_card == e_cpu).all(dim=-1).sum())}/{n_tok}; the block {block_ms:.3f} ms "
            f"on the card")
        if not same_bits or float(aux1["moe_drop_frac"]) != float(aux2["moe_drop_frac"]):
            errors.append("14c: two card runs of the MoE block differ")
        if not float(aux1["moe_drop_frac"]) > 0:
            errors.append("14c: no record dropped; the case is there to drop")
        del p, p_cpu, x, y1, y2, y_cpu
        torch.cuda.empty_cache()
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("14 MoE serving", phase_moe)

    # ---- 15. the recurrent and image-prefix families ----------------------------
    def phase_recurrent():
        from repro_torch.configs import get_config
        from repro_torch.models import zamba2
        from repro_torch.models.api import build_model, param_shapes
        from repro_torch.models.common import param_bytes
        errors = []
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        slots, max_len, prompt_len, gen_len, nreq = 8, 128, 32, 32, 8
        b, n = 2, 16
        rng = np.random.default_rng(0)

        def service(tag, full, state_of):
            """``full`` seeded in bfloat16 on the card and served twice; its
            decode step against the bytes bound: parameters, the recurrent
            state read and written, a KV cache read (``state_of(cache)`` gives
            the state's and the KV cache's bytes). Returns the launch counts."""
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = build_model(full, "cuda")
            params = model.init(0)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            pbytes = param_bytes(params)
            state, kv = state_of(model.init_cache(slots, max_len))
            bound_ms = (pbytes + 2 * state + kv) / HBM_BYTES_PER_S * 1e3
            prompts = [rng.integers(0, full.vocab, prompt_len).astype(np.int32)
                       for _ in range(nreq)]
            ops.reset_launch_counts()
            runs = serve_twice(full, params, prompts, slots=slots, max_len=max_len,
                               gen_len=gen_len)
            counts = ops.launch_counts()
            (s0, out0, _), (s1, out1, _) = runs
            line, med, ntok = service_line(runs)
            peak = torch.cuda.max_memory_allocated()
            log(f"{tag} {full.name}, {full.n_layers} layers, {full.dtype}: {pbytes} parameter bytes "
                f"initialised on the card in {init_s:.2f} s; {nreq} requests, {slots} slots, "
                f"prompt {prompt_len}, gen {gen_len}, max_len {max_len}: {line}; peak "
                f"{peak / 2**30:.2f} GiB; step bound {bound_ms:.3f} ms (parameters {pbytes} + "
                f"recurrent state {state} bytes read and written + KV cache {kv} bytes at "
                f"3.35 TB/s), {100 * bound_ms / med:.1f}% of it; launches of the hand kernels "
                f"over both runs {counts}")
            tok = torch.as_tensor([out0[r][-1] for r in range(nreq)], dtype=torch.int64,
                                  device=dev)
            pos = torch.full((slots,), prompt_len + gen_len - 1, dtype=torch.int64, device=dev)
            profile_decode(torch, model, params, {"token": tok, "pos": pos, "cache": s0.cache},
                           tag)
            log(f"{tag} the two runs' tokens equal: {out0 == out1}")
            if out0 != out1:
                errors.append(f"{tag}: two runs' tokens differ")
            if ntok != nreq * gen_len:
                errors.append(f"{tag}: {ntok} tokens, not {nreq * gen_len}")
            if any(counts.values()):
                errors.append(f"{tag}: a hand kernel launched on the path: {counts}")
            del model, params, runs, s0, s1
            torch.cuda.empty_cache()
            return counts

        def tree_bytes(tree, keep):
            return sum(param_bytes(v) for k, v in tree.items() if keep(k))

        # (a) zamba2-7b numerics: full width, 6 layers (the shared block at i = 5)
        full = get_config("zamba2_7b")
        cfg = dataclasses.replace(full, n_layers=6, dtype="float32")
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, n)), device=dev)
        model, params, fwd, text, errs = card_vs_cpu(torch, cfg, {"tokens": tokens}, tol=1e-3,
                                                     dec_tol=1e-3)
        errors += [f"15a: {e}" for e in errs]
        chunked = build_model(dataclasses.replace(cfg, ssm_chunk=8), "cuda").forward(
            params, {"tokens": tokens})[0]
        chunk_err = float((chunked - fwd).abs().max())
        if not torch.allclose(chunked, fwd, rtol=1e-3, atol=1e-3):
            errors.append("15a: the forward at chunk 8 differs from one chunk of 16")
        log(f"15a zamba2-7b full width (d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
            f"heads, ssm_state {cfg.ssm_state}, head_dim {cfg.ssm_head_dim}, d_ff {cfg.d_ff}), "
            f"{cfg.n_layers} layers, shared attention at {zamba2.attn_sites(cfg)}, float32, TF32 "
            f"off, {param_bytes(params)} parameter bytes, tokens [{b}, {n}]: {text}; the "
            f"forward at SSM chunk 8 (2 chunks) vs one chunk of 16 on the card max abs diff "
            f"{chunk_err:.3g} (rtol and atol 0.001)")
        del model, params, fwd, chunked
        torch.cuda.empty_cache()

        # (b) zamba2-7b served: 14 of the 81 layers (the shared block at 2 of
        # its 13 sites), bfloat16; the depth cut to keep the script inside its
        # time limit
        full = dataclasses.replace(full, n_layers=14)
        sites = len(zamba2.attn_sites(full))
        ctx["hybrid_counts"] = service("15b", full, lambda c: (
            tree_bytes(c, lambda k: k.startswith("ssm_")),
            tree_bytes(c, lambda k: k.startswith("attn_"))))
        log(f"15b {sites} shared-attention sites, each with its own KV cache")

        # (c) xlstm-350m: full width and depth; float32 numerics, then served
        full = get_config("xlstm_350m")
        cfg = dataclasses.replace(full, dtype="float32")
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, n)), device=dev)
        model, params, fwd, text, errs = card_vs_cpu(torch, cfg, {"tokens": tokens}, tol=1e-3,
                                                     dec_tol=2e-3)
        errors += [f"15c: {e}" for e in errs]
        log(f"15c xlstm-350m full width and depth (d_model {cfg.d_model}, {cfg.n_heads} heads, "
            f"{cfg.n_layers} layers, mLSTM and sLSTM alternating), float32, TF32 off, "
            f"{param_bytes(params)} parameter bytes, tokens [{b}, {n}]: {text} (the "
            f"reference's decode-vs-forward tolerance: the forward's stabiliser is global)")
        del model, params, fwd
        torch.cuda.empty_cache()
        ctx["xlstm_counts"] = service("15c", full, lambda c: (param_bytes(c), 0))

        # (d) paligemma-3b: the image prefix at full width
        full = get_config("paligemma_3b")
        cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
        img = torch.as_tensor(rng.standard_normal((b, cfg.img_tokens, cfg.img_dim)),
                              dtype=torch.float32, device=dev)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, n)), device=dev)
        model, params, fwd, text, errs = card_vs_cpu(
            torch, cfg, {"tokens": tokens, "img_emb": img}, tol=1e-3, last_only=True)
        errors += [f"15d: {e}" for e in errs]
        log(f"15d paligemma-3b full width (d_model {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), 2 layers, float32, "
            f"TF32 off, {param_bytes(params)} parameter bytes, image [{b}, {cfg.img_tokens}, "
            f"{cfg.img_dim}] + tokens [{b}, {n}], the last position's logits (last_only: "
            f"[{b}, {cfg.img_tokens + n}, {cfg.vocab}] logits on the CPU cost too much): {text}")
        del model, params, fwd
        torch.cuda.empty_cache()

        pb, text_len = 8, 32
        torch.cuda.reset_peak_memory_stats()
        model = build_model(full, "cuda")
        params = model.init(0)
        pbytes = param_bytes(params)
        batch = {"tokens": torch.as_tensor(rng.integers(0, full.vocab, (pb, text_len)),
                                           device=dev),
                 "img_emb": torch.randn((pb, full.img_tokens, full.img_dim), device=dev,
                                        dtype=torch.bfloat16)}
        seq = full.img_tokens + text_len
        ops.reset_launch_counts()
        logits = model.prefill_step(params, batch)
        torch.cuda.synchronize()
        ctx["vlm_counts"] = ops.launch_counts()
        prefill_ms = time_single(torch, lambda: model.prefill_step(params, batch), reps=5)
        peak = torch.cuda.max_memory_allocated()
        # FLOPs the prefill needs: the image projection, every layer's products
        # over all positions, causal attention's pairs, the last position's head
        shapes = param_shapes(full)
        layer = sum(int(np.prod(shape)) for part in ("attn", "mlp")
                    for shape in shapes["layer_0"][part].values())
        pairs = seq * (seq + 1) // 2
        flops = (2 * pb * full.img_tokens * full.img_dim * full.d_model
                 + 2 * pb * seq * full.n_layers * layer
                 + 4 * pb * pairs * full.n_heads * full.hd * full.n_layers
                 + 2 * pb * full.d_model * full.vocab)
        flop_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = pbytes / HBM_BYTES_PER_S * 1e3
        profiled(torch, lambda: (model.prefill_step(params, batch), torch.cuda.synchronize()),
                 "15d", "prefill")
        full_logits = model.forward(params, batch)[0][:, -1]
        last_err = float((logits - full_logits).abs().max())
        # one bfloat16 rounding of the head's product apart (another GEMM shape)
        if not torch.allclose(logits, full_logits, rtol=2.0 ** -7, atol=2.0 ** -6):
            errors.append("15d: prefill logits differ from the forward's last position")
        if not bool(torch.isfinite(logits).all()) or tuple(logits.shape) != (pb, full.vocab):
            errors.append(f"15d: prefill logits {tuple(logits.shape)} not finite or misshaped")
        if any(ctx["vlm_counts"].values()):
            errors.append(f"15d: a hand kernel launched on the path: {ctx['vlm_counts']}")
        log(f"15d paligemma-3b, {full.n_layers} layers, bfloat16, {pbytes} parameter bytes: "
            f"prefill_step on {pb} x ({full.img_tokens} image + {text_len} text) tokens, median "
            f"of 5 {prefill_ms:.3f} ms; FLOP bound {flop_ms:.3f} ms ({flops / 1e12:.4f} TFLOP at "
            f"989 TFLOP/s dense bfloat16), {100 * flop_ms / prefill_ms:.1f}% of it (bytes bound "
            f"{bytes_ms:.3f} ms); peak {peak / 2**30:.2f} GiB; logits against the forward's last "
            f"position max abs diff {last_err:.3g} (rtol 2^-7, atol 2^-6); launches of the hand "
            f"kernels {ctx['vlm_counts']}")
        del model, params, batch, logits, full_logits
        torch.cuda.empty_cache()
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("15 recurrent and image-prefix families", phase_recurrent)

    # ---- 16. whisper-large-v3's encoder-decoder at full width ----------------
    def phase_whisper():
        from repro_torch.configs import get_config
        from repro_torch.models import whisper
        from repro_torch.models.api import build_model
        from repro_torch.models.common import param_bytes
        errors = []
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        full = get_config("whisper_large_v3")
        rng = np.random.default_rng(0)

        # (a) 2 encoder + 2 decoder layers, float32: the forward on the card
        # against the CPU; decode with the encoder's cross K/V in the cache
        # against the teacher-forced decoder, position by position
        cfg = dataclasses.replace(full, n_layers=2, enc_layers=2, dtype="float32")
        b, n = 1, 16
        frames = torch.as_tensor(rng.standard_normal((b, cfg.enc_len, cfg.d_model)),
                                 dtype=torch.float32, device=dev)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, n)), device=dev)
        model, params, fwd, text, errs = card_vs_cpu(
            torch, cfg, {"frames": frames, "tokens": tokens}, tol=1e-3)
        errors += [f"16a: {e}" for e in errs]
        enc = whisper.encode(params, frames, cfg)
        cache = whisper.fill_cross_cache(params, model.init_cache(b, n), enc, cfg)
        dec_err, dec_ok = 0.0, True
        for t in range(n):
            lg, cache = model.serve_step(params, {"token": tokens[:, t], "pos": torch.tensor(t),
                                                  "cache": cache})
            dec_err = max(dec_err, float((lg - fwd[:, t]).abs().max()))
            dec_ok &= torch.allclose(lg, fwd[:, t], rtol=1e-3, atol=1e-3)
        if not dec_ok:
            errors.append("16a: decode with the encoder's cross cache vs forward beyond tolerance")
        log(f"16a whisper-large-v3 full width (d_model {cfg.d_model}, {cfg.n_heads} heads, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, enc_len {cfg.enc_len}), 2 encoder + 2 decoder "
            f"layers, float32, TF32 off, {param_bytes(params)} parameter bytes, frames [{b}, "
            f"{cfg.enc_len}, {cfg.d_model}] + tokens [{b}, {n}]: {text}; decode with the "
            f"encoder's cross K/V vs the forward on the card max abs diff {dec_err:.3g} (rtol "
            f"and atol 0.001)")
        del model, params, fwd, enc, cache
        torch.cuda.empty_cache()

        # (b) 16 + 16 of the 32 + 32 layers, bfloat16 (the depth cut for the
        # time limit)
        full = dataclasses.replace(full, enc_layers=16, n_layers=16)
        slots, max_len, prompt_len, gen_len, nreq = 8, 128, 32, 32, 8
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = build_model(full, "cuda")
        params = model.init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pbytes = param_bytes(params)
        d, f, t_enc = full.d_model, full.d_ff, full.enc_len
        frames = torch.randn((slots, t_enc, d), device=dev, dtype=torch.bfloat16)
        # the encoder's FLOPs: every layer's products over all frames, and its
        # unmasked attention (QK^T and PV)
        enc_layer = sum(int(np.prod(x.shape)) for k in ("attn", "mlp")
                        for name, x in params["enc_0"][k].items() if name.startswith("w"))
        enc_flops = full.enc_layers * (2 * slots * t_enc * enc_layer
                                       + 4 * slots * t_enc * t_enc * full.n_heads * full.hd)
        enc_bound = enc_flops / BF16_FLOPS * 1e3
        enc_out = whisper.encode(params, frames, full)
        encode_ms = time_single(torch, lambda: whisper.encode(params, frames, full), reps=5)
        profiled(torch, lambda: (whisper.encode(params, frames, full), torch.cuda.synchronize()),
                 "16b", "encode")
        cache = model.init_cache(slots, max_len)
        xkv_flops = 2 * slots * t_enc * d * 2 * d * full.n_layers
        xkv_ms = time_single(torch, lambda: whisper.fill_cross_cache(params, cache, enc_out, full),
                             reps=5)
        prompt_tokens = torch.as_tensor(rng.integers(0, full.vocab, (slots, prompt_len)),
                                        device=dev)
        pre = model.prefill_step(params, {"frames": frames, "tokens": prompt_tokens})
        prefill_ms = time_single(torch, lambda: model.prefill_step(
            params, {"frames": frames, "tokens": prompt_tokens}), reps=5)
        if not bool(torch.isfinite(pre).all()) or tuple(pre.shape) != (slots, full.vocab):
            errors.append(f"16b: prefill logits {tuple(pre.shape)} not finite or misshaped")
        if not bool(torch.isfinite(enc_out.float()).all()):
            errors.append("16b: the encoder's output is not finite")
        log(f"16b whisper-large-v3, {full.enc_layers} + {full.n_layers} layers, bfloat16: "
            f"{pbytes} parameter bytes initialised on the card in {init_s:.2f} s; encode of "
            f"{slots} x {t_enc} frames median of 5 {encode_ms:.3f} ms against the FLOP bound "
            f"{enc_bound:.3f} ms ({enc_flops / 1e12:.4f} TFLOP at 989 TFLOP/s dense bfloat16), "
            f"{100 * enc_bound / encode_ms:.1f}% of it; the cross K/V of {full.n_layers} layers "
            f"projected into the cache {xkv_ms:.3f} ms (FLOP bound "
            f"{xkv_flops / BF16_FLOPS * 1e3:.3f} ms); prefill_step (encode + {prompt_len} "
            f"tokens, the last position's logits) {prefill_ms:.3f} ms")
        del cache, pre

        # served as the reference serves whisper: the cross K/V stay zero
        prompts = [rng.integers(0, full.vocab, prompt_len).astype(np.int32)
                   for _ in range(nreq)]
        ops.reset_launch_counts()
        runs = serve_twice(full, params, prompts, slots=slots, max_len=max_len, gen_len=gen_len)
        ctx["whisper_counts"] = ops.launch_counts()
        (s0, out0, _), (s1, out1, _) = runs
        line, med, ntok = service_line(runs)
        peak = torch.cuda.max_memory_allocated()
        # a decode step reads the decoder's weights but the cross wk/wv (the
        # cross K/V come from the cache), the tied head, the self KV cache and
        # the cross K/V; the encoder is not run
        dec_w = sum(param_bytes(v) for k, v in params.items() if k.startswith("dec_")) - sum(
            param_bytes(params[f"dec_{i}"]["cross_attn"][w])
            for i in range(full.n_layers) for w in ("wk", "wv"))
        head = param_bytes(params["embed"]) + param_bytes(params["ln_dec"])
        cache_b = param_bytes(s0.cache)
        bound_ms = (dec_w + head + cache_b) / HBM_BYTES_PER_S * 1e3
        log(f"16b served: {nreq} requests, {slots} slots, prompt {prompt_len}, gen {gen_len}, "
            f"max_len {max_len}, the cross K/V zero as the reference serves them: {line}; peak "
            f"{peak / 2**30:.2f} GiB; step bound {bound_ms:.3f} ms (decoder weights without the "
            f"cross wk/wv {dec_w} + head {head} + self and cross K/V cache {cache_b} bytes at "
            f"3.35 TB/s), {100 * bound_ms / med:.1f}% of it; launches of the hand kernels over "
            f"both runs {ctx['whisper_counts']}")
        # a profiled decode step with the encoder's cross K/V in the cache
        whisper.fill_cross_cache(params, s0.cache, enc_out, full)
        tok = torch.as_tensor([out0[r][-1] for r in range(nreq)], dtype=torch.int64, device=dev)
        pos = torch.full((slots,), prompt_len + gen_len - 1, dtype=torch.int64, device=dev)
        profile_decode(torch, model, params, {"token": tok, "pos": pos, "cache": s0.cache}, "16b")
        log(f"16b the two runs' tokens equal: {out0 == out1}")
        if out0 != out1:
            errors.append("16b: two runs' tokens differ")
        if ntok != nreq * gen_len:
            errors.append(f"16b: {ntok} tokens, not {nreq * gen_len}")
        if any(ctx["whisper_counts"].values()):
            errors.append(f"16b: a hand kernel launched on the path: {ctx['whisper_counts']}")
        del model, params, runs, s0, s1, frames, enc_out
        torch.cuda.empty_cache()
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("16 whisper encoder-decoder", phase_whisper)

    # ---- 17. training: h2o-danube-1.8b at full width ---------------------------
    def phase_train():
        from repro_torch.configs import RunConfig, get_config
        from repro_torch.dist.compress import tree_leaves
        from repro_torch.dist.microbatch import value_and_grad
        from repro_torch.launch import train as train_lib
        from repro_torch.models.api import build_model
        from repro_torch.models.common import param_bytes, tree_to
        from repro_torch.optim import adamw_init, adamw_update
        errors = []
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        full = get_config("h2o_danube_1_8b")
        rng = np.random.default_rng(0)

        # (a) 2 float32 layers: the loss and every gradient leaf on the card
        # against the CPU (rtol 1e-3, atol 1e-4 of the largest gradient), then
        # one AdamW step from the CPU's gradients on both (rtol and atol 1e-6
        # of each leaf's largest magnitude)
        cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)), device=dev)
        model = build_model(cfg, "cuda")
        params = model.init(0)
        cpu_model, cpu_params = build_model(cfg, "cpu"), tree_to(params, "cpu")
        (loss, _), grads = value_and_grad(lambda p: model.loss(p, {"tokens": tokens}), params)
        (cpu_loss, _), cpu_grads = value_and_grad(
            lambda p: cpu_model.loss(p, {"tokens": tokens.cpu()}), cpu_params)
        got, want = tree_leaves(grads), tree_leaves(cpu_grads)
        gmax = max(float(w.abs().max()) for w in want)
        grad_err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        grads_ok = all(torch.allclose(g.cpu(), w, rtol=1e-3, atol=1e-4 * gmax)
                       for g, w in zip(got, want))
        loss_ok = abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
        lr = torch.tensor(3e-4)
        new_cpu, _, m_cpu = adamw_update(cpu_grads, adamw_init(cpu_params), cpu_params, lr=lr)
        new_card, _, m_card = adamw_update(tree_to(cpu_grads, dev), adamw_init(params), params,
                                           lr=lr.to(dev))
        opt_err = max(float((a.cpu() - b).abs().max())
                      for a, b in zip(tree_leaves(new_card), tree_leaves(new_cpu)))
        opt_ok = all(torch.allclose(a.cpu(), b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
                     for a, b in zip(tree_leaves(new_card), tree_leaves(new_cpu)))
        if not (loss_ok and grads_ok and opt_ok):
            errors.append(f"17a: card vs CPU beyond tolerance (loss {loss_ok}, gradients "
                          f"{grads_ok}, AdamW {opt_ok})")
        log(f"17a h2o-danube-1.8b full width (d_model {cfg.d_model}, {cfg.n_heads}/"
            f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), 2 layers, float32, "
            f"TF32 off, {param_bytes(params)} parameter bytes, tokens [2, 32]: loss card "
            f"{float(loss):.7f} CPU {float(cpu_loss):.7f}; {len(got)} gradient leaves, max abs "
            f"diff {grad_err:.3g} (largest |g| {gmax:.3g}); one AdamW step, max abs diff "
            f"{opt_err:.3g}, grad_norm card {float(m_card['grad_norm']):.6f} CPU "
            f"{float(m_cpu['grad_norm']):.6f}")
        del model, params, cpu_params, grads, cpu_grads, new_cpu, new_card
        torch.cuda.empty_cache()

        # (b) all 24 layers, bfloat16, through the trainer, twice
        steps, batch, seq = 6, 8, 128
        argv = ["--arch", "h2o_danube_1_8b", "--steps", str(steps), "--batch", str(batch),
                "--seq", str(seq), "--device", "cuda", "--log-every", "100"]
        ops.reset_launch_counts()
        first = train_lib.train(train_lib.parse_args(argv))
        ctx["train_counts"] = ops.launch_counts()
        first_params = first.params
        n_params = sum(x.numel() for x in tree_leaves(first_params))
        pbytes = param_bytes(first_params)
        first.opt = None
        torch.cuda.empty_cache()
        second = train_lib.train(train_lib.parse_args(argv))
        same_loss = first.losses == second.losses
        same_params = all(torch.equal(a, b) for a, b in zip(tree_leaves(first_params),
                                                            tree_leaves(second.params)))
        # phase 18a holds the trainer in an NCCL world of one against this run
        ctx["train_17b"] = {"argv": argv, "losses": first.losses, "params": first_params}
        del first_params, first.params
        torch.cuda.empty_cache()
        # the bound: 6·N FLOPs a token (forward and backward, no recompute) plus
        # causal attention's pairs, then AdamW's bytes: read p, g, mu, nu and
        # write p, mu, nu (bfloat16 parameters and gradients, float32 moments)
        pairs = seq * (seq + 1) // 2
        flops = 6 * n_params * batch * seq + 3 * 4 * batch * pairs * full.n_heads * full.hd * \
            full.n_layers
        opt_bytes = 3 * pbytes + 16 * n_params
        flop_ms = flops / BF16_FLOPS * 1e3
        bytes_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
        steps_ms = np.array(first.step_s[1:] + second.step_s[1:]) * 1e3
        med = float(np.median(steps_ms))
        peak = max(first.result["peak_memory_bytes"], second.result["peak_memory_bytes"])
        log(f"17b h2o-danube-1.8b, {full.n_layers} layers, bfloat16, {n_params} parameters "
            f"({pbytes} bytes), batch {batch} x seq {seq}, {steps} steps through "
            f"repro_torch.launch.train, twice: losses {[round(x, 6) for x in first.losses]}; "
            f"walls {first.result['wall_s']:.2f} s and {second.result['wall_s']:.2f} s, first "
            f"steps {1e3 * first.step_s[0]:.1f} and {1e3 * second.step_s[0]:.1f} ms, median of "
            f"the others {med:.3f} ms (p10 {np.percentile(steps_ms, 10):.3f}, p90 "
            f"{np.percentile(steps_ms, 90):.3f}); bound {flop_ms + bytes_ms:.3f} ms (FLOPs "
            f"{flops / 1e12:.4f} TFLOP at 989 TFLOP/s = {flop_ms:.3f} ms, plus AdamW's "
            f"{opt_bytes} bytes at 3.35 TB/s = {bytes_ms:.3f} ms), "
            f"{100 * (flop_ms + bytes_ms) / med:.1f}% of it; peak {peak / 2**30:.2f} GiB; "
            f"losses equal {same_loss}, final parameters equal bit for bit {same_params}; "
            f"launches of the hand kernels in the first run {ctx['train_counts']}")
        model = build_model(full, "cuda")
        step_fn = train_lib.build_train_step(model, RunConfig(total_steps=steps, warmup_steps=1),
                                             1)
        state = {"p": second.params, "o": second.opt}
        del second
        toks = torch.as_tensor(rng.integers(0, full.vocab, (batch, seq)), device=dev)

        def one_step():
            state["p"], state["o"], _, m = step_fn(state["p"], state["o"], {"tokens": toks}, None)
            float(m["loss"])

        profiled(torch, one_step, "17b", "training step")
        del state, model
        torch.cuda.empty_cache()
        if not (same_loss and same_params):
            errors.append("17b: two runs' losses or parameters differ")
        if any(ctx["train_counts"].values()):
            errors.append(f"17b: a hand kernel launched on the path: {ctx['train_counts']}")

        # (c) 2 bfloat16 layers at full width: checkpoints at 3 and 6, the
        # step-6 one removed, resumed from 3: equal to the uninterrupted run;
        # then --compress int8, its wire bytes against the priced
        ck = os.path.join(ctx["tmp"], "train-ckpt")
        small = ["--arch", "h2o_danube_1_8b", "--steps", "6", "--batch", "4", "--seq", "64",
                 "--device", "cuda", "--log-every", "100"]
        two = dataclasses.replace(full, n_layers=2)
        whole = train_lib.train(train_lib.parse_args(small + ["--ckpt-dir", ck, "--ckpt-every",
                                                              "3"]), cfg=two)
        shutil.rmtree(os.path.join(ck, "step_0000000006"))
        t0 = time.perf_counter()
        resumed = train_lib.train(train_lib.parse_args(
            small + ["--ckpt-dir", ck, "--ckpt-every", "3", "--resume"]), cfg=two)
        resume_s = time.perf_counter() - t0
        wire = train_lib.train(train_lib.parse_args(small + ["--compress", "int8"]), cfg=two)
        same = resumed.losses == whole.losses[3:] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves((resumed.params, resumed.opt)),
                                              tree_leaves((whole.params, whole.opt))))
        w = wire.result
        log(f"17c 2 bfloat16 layers at full width, 6 steps of batch 4 x seq 64: checkpoints "
            f"at steps 3 and 6, step 6 removed, --resume from 3 ({resume_s:.2f} s): losses "
            f"{[round(x, 6) for x in resumed.losses]} against "
            f"{[round(x, 6) for x in whole.losses[3:]]}, "
            f"parameters and optimizer state equal bit for bit {same}; --compress int8: wire "
            f"bytes a step {w['wire_bytes_per_step']:.0f}, priced {w['wire_bytes_expected']:.0f}, "
            f"loss_last {w['loss_last']:.6f} (uncompressed {whole.losses[-1]:.6f})")
        if not same:
            errors.append("17c: the resumed run differs from the uninterrupted one")
        if w["wire_bytes_per_step"] != w["wire_bytes_expected"]:
            errors.append("17c: wire bytes differ from the priced")
        if not all(np.isfinite(x) for x in whole.losses + wire.losses):
            errors.append("17c: a loss is not finite")
        del whole, resumed, wire
        torch.cuda.empty_cache()
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("17 training", phase_train)

    # ---- 18. multi-rank training --------------------------------------------
    def phase_train_dp():
        import torch.distributed as tdist
        from repro_torch.configs import RunConfig, get_config
        from repro_torch.core.query_engine import RankSet
        from repro_torch.data import SyntheticTokens, TokenDatasetConfig
        from repro_torch.dist.compress import tree_leaves
        from repro_torch.dist.microbatch import value_and_grad
        from repro_torch.launch import summarize as launch
        from repro_torch.launch import train as train_lib
        from repro_torch.models import moe as moe_lib
        from repro_torch.models.api import build_model
        from repro_torch.models.common import param_bytes, tree_to
        card = nvidia_smi("name,power.limit")
        errors = []
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        if "train_17b" not in ctx:
            raise AssertionError("phase 17b's run is not at hand")
        ref = ctx.pop("train_17b")
        launch.init_distributed(dev)  # NCCL, a world of one
        try:
            # (a) danube's 24 bfloat16 layers through the trainer in the group,
            # at 17b's settings: 17b's first run bit for bit
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            run = train_lib.train(train_lib.parse_args(ref["argv"]))
            wall_a = time.perf_counter() - t0
            ctx["dp_counts"] = ops.launch_counts()
            same_loss = run.losses == ref["losses"]
            same_params = all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(run.params), tree_leaves(ref["params"])))
            world = run.result["world"]
            del ref, run
            torch.cuda.empty_cache()
            two = dataclasses.replace(get_config("h2o_danube_1_8b"), n_layers=2)
            small = ["--arch", "h2o_danube_1_8b", "--steps", "3", "--batch", "4", "--seq",
                     "64", "--device", "cuda", "--log-every", "100", "--compress", "int8"]
            w = train_lib.train(train_lib.parse_args(small), cfg=two).result
            log(f"[{card}] 18a h2o-danube-1.8b, 24 bfloat16 layers, through "
                f"repro_torch.launch.train in an NCCL group of {world} "
                f"({tdist.get_backend()}), phase 17b's settings: {wall_a:.2f} s; losses equal "
                f"to 17b's first run {same_loss}, final parameters bit for bit {same_params}; "
                f"--compress int8 on 2 layers: wire bytes a step "
                f"{w['wire_bytes_per_step']:.0f}, 1 x payload_bytes "
                f"{w['wire_bytes_expected']:.0f}, world {w['world']}; launches of the hand "
                f"kernels {ctx['dp_counts']}")
            if world != 1 or not (same_loss and same_params):
                errors.append(f"18a: the trainer in a group of {world} differs from 17b "
                              f"(losses {same_loss}, parameters {same_params})")
            if w["world"] != 1 or w["wire_bytes_per_step"] != w["wire_bytes_expected"]:
                errors.append("18a: int8 wire bytes differ from 1 x payload_bytes")

            # (b) granite-moe-3b-a800m at full width: 2 float32 layers at
            # capacity factor 1.25 (records drop), loss and gradients on the
            # card against the CPU; then 8 of its 32 bfloat16 layers through
            # the trainer, twice
            full = get_config("granite_moe_3b_a800m")
            cfg = dataclasses.replace(full, n_layers=2, dtype="float32")
            tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 32)),
                                     device=dev)
            model = build_model(cfg, "cuda")
            params = model.init(0)
            with MoeRecorder(moe_lib) as rec_card:
                (loss, _), grads = value_and_grad(
                    lambda p: model.loss(p, {"tokens": tokens}), params)
            cpu_model, cpu_params = build_model(cfg, "cpu"), tree_to(params, "cpu")
            with MoeRecorder(moe_lib) as rec_cpu:
                (cpu_loss, _), cpu_grads = value_and_grad(
                    lambda p: cpu_model.loss(p, {"tokens": tokens.cpu()}), cpu_params)
            got, want = tree_leaves(grads), tree_leaves(cpu_grads)
            gmax = max(float(x.abs().max()) for x in want)
            grad_err = max(float((g.cpu() - x).abs().max()) for g, x in zip(got, want))
            grads_ok = all(torch.allclose(g.cpu(), x, rtol=1e-3, atol=1e-4 * gmax)
                           for g, x in zip(got, want))
            loss_ok = abs(float(loss) - float(cpu_loss)) <= 1e-5 * abs(float(cpu_loss))
            drops = (rec_card.drop_fracs(), rec_cpu.drop_fracs())
            log(f"18b granite-moe-3b-a800m full width (d_model {cfg.d_model}, "
                f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, padded "
                f"{params['layer_0']['moe']['router'].shape[-1]}), 2 layers, float32, TF32 "
                f"off, capacity factor {cfg.moe.capacity_factor}, tokens [2, 32]: loss card "
                f"{float(loss):.7f} CPU {float(cpu_loss):.7f}; {len(got)} gradient leaves, "
                f"max abs diff {grad_err:.3g} (largest |g| {gmax:.3g}); drop fractions card "
                f"{drops[0]}, CPU {drops[1]} by layer")
            if not (loss_ok and grads_ok):
                errors.append(f"18b: card vs CPU beyond tolerance (loss {loss_ok}, gradients "
                              f"{grads_ok})")
            if drops[0] != drops[1] or not any(f > 0 for f in drops[0]):
                errors.append(f"18b: drop fractions {drops}: not equal, or none dropped")
            del model, params, cpu_params, grads, cpu_grads, rec_card, rec_cpu
            torch.cuda.empty_cache()

            steps, batch, seq = 4, 8, 128
            eight = dataclasses.replace(full, n_layers=8)
            argv = ["--arch", "granite_moe_3b_a800m", "--steps", str(steps), "--batch",
                    str(batch), "--seq", str(seq), "--device", "cuda", "--log-every", "100"]
            ops.reset_launch_counts()
            first = train_lib.train(train_lib.parse_args(argv), cfg=eight)
            ctx["moe_train_counts"] = ops.launch_counts()
            first_params = first.params
            first.opt = first.params = None
            torch.cuda.empty_cache()
            second = train_lib.train(train_lib.parse_args(argv), cfg=eight)
            same_loss = first.losses == second.losses
            same_params = all(torch.equal(a, b) for a, b in
                              zip(tree_leaves(first_params), tree_leaves(second.params)))
            del first_params
            n_params = sum(x.numel() for x in tree_leaves(second.params))
            pbytes = param_bytes(second.params)
            e_pad = full.moe.experts_padded(moe_lib.EP)
            d, f, k = full.d_model, full.d_ff, full.moe.top_k
            # the bound: 6 FLOPs a routed parameter a token (k of the experts),
            # causal attention's pairs, and AdamW's bytes over every parameter
            n_active = n_params - eight.n_layers * (e_pad - k) * 3 * d * f
            pairs = seq * (seq + 1) // 2
            flops = 6 * n_active * batch * seq + 3 * 4 * batch * pairs * full.n_heads * \
                full.hd * eight.n_layers
            opt_bytes = 3 * pbytes + 16 * n_params
            flop_ms = flops / BF16_FLOPS * 1e3
            bytes_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
            steps_ms = np.array(first.step_s[1:] + second.step_s[1:]) * 1e3
            med = float(np.median(steps_ms))
            peak = max(first.result["peak_memory_bytes"], second.result["peak_memory_bytes"])
            ds = SyntheticTokens(TokenDatasetConfig(vocab=full.vocab, seq_len=seq,
                                                    global_batch=batch, seed=0))
            toks = torch.as_tensor(ds.batch(0).astype(np.int64), device=dev)
            model = build_model(eight, "cuda")
            with torch.no_grad(), MoeRecorder(moe_lib) as rec:
                model.forward(second.params, {"tokens": toks})
            drop = rec.drop_fracs()
            log(f"18b granite-moe-3b-a800m, {eight.n_layers} of {full.n_layers} layers, "
                f"bfloat16, {n_params} parameters ({pbytes} bytes; {n_active} routed a "
                f"token), batch {batch} x seq {seq}, {steps} steps through "
                f"repro_torch.launch.train in the group, twice: losses "
                f"{[round(x, 6) for x in first.losses]}; walls {first.result['wall_s']:.2f} s "
                f"and {second.result['wall_s']:.2f} s, first steps "
                f"{1e3 * first.step_s[0]:.1f} and {1e3 * second.step_s[0]:.1f} ms, median of "
                f"the others {med:.3f} ms (p10 {np.percentile(steps_ms, 10):.3f}, p90 "
                f"{np.percentile(steps_ms, 90):.3f}); bound {flop_ms + bytes_ms:.3f} ms (FLOPs "
                f"{flops / 1e12:.4f} TFLOP at 989 TFLOP/s = {flop_ms:.3f} ms, plus AdamW's "
                f"{opt_bytes} bytes at 3.35 TB/s = {bytes_ms:.3f} ms), "
                f"{100 * (flop_ms + bytes_ms) / med:.1f}% of it; peak {peak / 2**30:.2f} GiB; "
                f"drop fraction by layer on step 0's batch after training "
                f"{[round(x, 5) for x in drop]}; losses equal {same_loss}, final parameters "
                f"bit for bit {same_params}; launches of the hand kernels in the first run "
                f"{ctx['moe_train_counts']}")
            step_fn = train_lib.build_train_step(
                model, RunConfig(total_steps=steps, warmup_steps=1), 1)
            state = {"p": second.params, "o": second.opt}

            def one_step():
                state["p"], state["o"], _, m = step_fn(state["p"], state["o"],
                                                       {"tokens": toks}, None)
                float(m["loss"])

            profiled(torch, one_step, "18b", "MoE training step")
            if not (same_loss and same_params):
                errors.append("18b: two MoE training runs differ")
            if not all(np.isfinite(x) for x in first.losses):
                errors.append("18b: a loss is not finite")
            del first, second, model, rec, state, step_fn
            torch.cuda.empty_cache()

            # (c) granite's MoE block at full width, float32: the
            # expert-parallel path with EP = 4 in this process and over
            # all_to_all_single in the group of one, against the GSPMD path
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            p = moe_lib.init_moe(gen, full, torch.float32, dev)
            x = (torch.randn((8, 128, d), generator=gen, device=dev)
                 + torch.randn((d,), generator=gen, device=dev))
            keys = ("router", "wg", "wi", "wo")
            ep4, group1 = RankSet(dev, ranks=4), RankSet(dev)
            e_local = e_pad // 4
            shards = [x[:, j * 32:(j + 1) * 32] for j in range(4)]

            def fwd_bwd(path, cfg_):
                leaves = {kk: v.detach().requires_grad_(True) for kk, v in p.items()}
                if path == "gspmd":
                    y, aux = moe_lib.apply_moe_gspmd(leaves, x, cfg_)
                elif path == "EP = 4 in one process":
                    locs = [{"router": leaves["router"], **{
                        kk: leaves[kk][j * e_local:(j + 1) * e_local]
                        for kk in ("wi", "wg", "wo")}} for j in range(4)]
                    ys, auxes = moe_lib.apply_moe(locs, shards, cfg_, ep=ep4)
                    y, aux = torch.cat(ys, dim=1), auxes[0]
                else:
                    y, aux = moe_lib.apply_moe(leaves, x, cfg_, ep=group1)
                gs = torch.autograd.grad((y.float() ** 2).sum(), [leaves[kk] for kk in keys])
                return y.detach(), dict(zip(keys, gs)), aux["moe_drop_frac"]

            paths = ("gspmd", "EP = 4 in one process", "all_to_all_single, group of one")
            a2a_of = {c: dataclasses.replace(full, moe=dataclasses.replace(
                full.moe, capacity_factor=c, impl="a2a")) for c in (8.0, 1.25)}
            ops.reset_launch_counts()
            res = {pth: fwd_bwd(pth, a2a_of[8.0]) for pth in paths}
            y0, g0, _ = res["gspmd"]
            parts = []
            for pth in paths[1:]:
                y, g, drop = res[pth]
                y_err = float((y - y0).abs().max())
                g_err = max(float((g[kk] - g0[kk]).abs().max() / g0[kk].abs().max())
                            for kk in keys)
                ok = torch.allclose(y, y0, rtol=2e-4, atol=2e-5) and all(
                    torch.allclose(g[kk], g0[kk], rtol=2e-4,
                                   atol=2e-5 * float(g0[kk].abs().max())) for kk in keys)
                parts.append(f"{pth}: y max abs diff {y_err:.3g}, gradients max diff "
                             f"{g_err:.3g} of each leaf's largest, drop {float(drop)}")
                if not ok or float(drop) != 0.0:
                    errors.append(f"18c: {pth} at capacity factor 8 parts from GSPMD")
            drops, same, times = {}, {}, {}
            for pth in paths:
                r1 = fwd_bwd(pth, a2a_of[1.25])
                r2 = fwd_bwd(pth, a2a_of[1.25])
                drops[pth] = float(r1[2])
                same[pth] = torch.equal(r1[0].view(torch.int32), r2[0].view(torch.int32)) and \
                    all(torch.equal(r1[1][kk], r2[1][kk]) for kk in keys)
                times[pth] = time_cuda(torch, lambda: fwd_bwd(pth, a2a_of[1.25]), launches=3,
                                       batches=3, warmup=1)
            ctx["a2a_counts"] = ops.launch_counts()
            log(f"18c granite's MoE block at full width, float32, TF32 off, x {list(x.shape)}, "
                f"{e_pad} padded experts; capacity factor 8 (no drop), each path against "
                f"GSPMD held to rtol 2e-4, atol 2e-5 (gradients of sum(y^2): 2e-5 of each "
                f"leaf's largest): {'; '.join(parts)}; capacity factor 1.25: drop fractions "
                f"{drops}; two runs bit-identical (y and gradients) {same}; forward + "
                f"backward device ms {({kk: round(v, 3) for kk, v in times.items()})}; "
                f"launches of the hand kernels {ctx['a2a_counts']}")
            if not all(same.values()):
                errors.append(f"18c: two runs differ: {same}")
            if not drops["gspmd"] > 0 or not drops["EP = 4 in one process"] > 0:
                errors.append(f"18c: no record dropped at capacity factor 1.25: {drops}")
            del p, x, res, y0, g0
            torch.cuda.empty_cache()
        finally:
            tdist.destroy_process_group()
        for name in ("dp_counts", "moe_train_counts", "a2a_counts"):
            if any(ctx.get(name, {}).values()):
                errors.append(f"18: a hand kernel launched on the path: {ctx[name]}")
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("18 multi-rank training", phase_train_dp)

    def phase_train_tp():
        import torch.distributed as tdist
        from repro_torch.configs import get_config
        from repro_torch.dist.compress import tree_leaves
        from repro_torch.dist.fsdp import Sharded
        from repro_torch.dist.sharding import make_rules
        from repro_torch.launch import summarize as launch
        from repro_torch.launch import train as train_lib
        from repro_torch.models import attention as attn
        from repro_torch.models import moe as moe_lib
        from repro_torch.models import tp_ranks, transformer
        from repro_torch.models.api import build_model, param_axes, param_shapes
        from repro_torch.models.common import apply_mlp
        from repro_torch.models.losses import causal_lm_loss
        from repro_torch.runtime import plan_mesh
        card = nvidia_smi("name,power.limit")
        errors, times = [], {}
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        danube = get_config("h2o_danube_1_8b")

        # (a) --want-model 2 in an NCCL group of one plans (1, 1): the
        # --want-model 1 run bit for bit, at 17b's batch, 2 bfloat16 layers
        two = dataclasses.replace(danube, n_layers=2)
        argv = ["--arch", "h2o_danube_1_8b", "--steps", "3", "--batch", "8", "--seq", "128",
                "--device", "cuda", "--log-every", "100"]
        launch.init_distributed(dev)  # NCCL, a world of one
        try:
            one = train_lib.train(train_lib.parse_args(argv), cfg=two)
            one_params = [x.clone() for x in tree_leaves(one.params)]
            del one.params, one.opt, one.shards
            torch.cuda.empty_cache()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            tp_run = train_lib.train(train_lib.parse_args(argv + ["--want-model", "2"]), cfg=two)
            wall_a = time.perf_counter() - t0
            ctx["tp_counts"] = ops.launch_counts()
            backend = tdist.get_backend()
        finally:
            tdist.destroy_process_group()
        same = tp_run.losses == one.losses and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(tp_run.params), one_params))
        res = tp_run.result
        log(f"[{card}] 19a h2o-danube-1.8b full width, 2 bfloat16 layers, batch 8 x 128, "
            f"3 steps through repro_torch.launch.train --want-model 2 in an NCCL group of "
            f"{res['world']} ({backend}): mesh {res['mesh']}, {wall_a:.2f} s; losses "
            f"{[round(x, 6) for x in tp_run.losses]}; equal to the --want-model 1 run bit for "
            f"bit {same}; stored_bytes_per_rank {res['stored_bytes_per_rank']} (--want-model "
            f"1: {one.result['stored_bytes_per_rank']}); launches of the hand kernels "
            f"{ctx['tp_counts']}")
        if not same or res["mesh"] != {"data": 1, "model": 1}:
            errors.append(f"19a: --want-model 2 at a world of one differs (mesh {res['mesh']})")
        del tp_run, one_params
        torch.cuda.empty_cache()

        # (b) each tensor-parallel layer's ranks at full width in this
        # process (models/tp_ranks.py) against the unsplit layer, float32:
        # forward and the gradients of sum(y^2), rtol 2e-4, atol 2e-5
        # (18c's; the gradients' atol of each leaf's largest)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        f32 = dataclasses.replace(danube, dtype="float32")
        d, f, h, k, hd = f32.d_model, f32.d_ff, f32.n_heads, f32.n_kv_heads, f32.hd

        def leaf(*shape, scale=None):
            sc = scale if scale is not None else 1.0 / float(np.sqrt(shape[0]))
            return (torch.randn(shape, generator=gen, device=dev) * sc).requires_grad_(True)

        x = leaf(2, 128, d, scale=1.0)
        mlp_p = {"wi": leaf(d, f), "wg": leaf(d, f), "wo": leaf(f, d)}
        att_p = {"wq": leaf(d, h, hd), "wk": leaf(d, k, hd), "wv": leaf(d, k, hd),
                 "wo": leaf(h, hd, d, scale=1.0 / float(np.sqrt(h * hd)))}
        table = leaf(f32.vocab, d, scale=0.02)
        tokens = torch.randint(0, f32.vocab, (2, 128), generator=gen, device=dev)
        granite = get_config("granite_moe_3b_a800m")
        moe_p = {kk: v.requires_grad_(True) for kk, v in
                 moe_lib.init_moe(gen, granite, torch.float32, dev).items()}
        xm = (torch.randn((8, 128, granite.d_model), generator=gen, device=dev)
              + torch.randn((granite.d_model,), generator=gen, device=dev)).requires_grad_(True)

        def embed_whole():
            hh = torch.tanh(transformer.embed_tokens({"embed": table}, tokens, f32))
            return causal_lm_loss(transformer.unembed({"embed": table}, hh, f32), tokens)[0]

        layers = {
            "MLP (d 2560, ff 6912)": (
                lambda m: tp_ranks.mlp(mlp_p, x, "silu", m),
                lambda: apply_mlp(mlp_p, x, "silu"), [x, *mlp_p.values()]),
            "attention (32 heads, 8 KV heads)": (
                lambda m: tp_ranks.attention(att_p, x, f32, m, window=f32.swa_window),
                lambda: attn.attention(att_p, x, f32, window=f32.swa_window),
                [x, *att_p.values()]),
            "embedding + loss (vocab 32000)": (
                lambda m: tp_ranks.embed_and_loss(table, torch.tanh, tokens, f32, m)[2][0],
                embed_whole, [table]),
            "granite MoE block (48 padded experts, x [8, 128, 1536])": (
                lambda m: tp_ranks.moe(moe_p, xm, granite, m)[0],
                lambda: moe_lib.apply_moe_gspmd(moe_p, xm, granite)[0],
                [xm, *moe_p.values()]),
        }

        def fwd_bwd(fn, leaves):
            y = fn()
            return y.detach(), torch.autograd.grad((y.float() ** 2).sum(), leaves)

        ops.reset_launch_counts()
        parts = []
        for name, (split, whole, leaves) in layers.items():
            y0, g0 = fwd_bwd(whole, leaves)
            times[name] = {"unsplit": time_cuda(torch, lambda: fwd_bwd(whole, leaves),
                                                launches=3, batches=3, warmup=1)}
            for m in (2, 4):
                y, g = fwd_bwd(lambda: split(m), leaves)
                y_err = float((y - y0).abs().max())
                g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g, g0))
                ok = torch.allclose(y, y0, rtol=2e-4, atol=2e-5) and all(
                    torch.allclose(a, b, rtol=2e-4, atol=2e-5 * float(b.abs().max()))
                    for a, b in zip(g, g0))
                times[name][f"m={m}"] = time_cuda(torch, lambda: fwd_bwd(lambda: split(m),
                                                                         leaves),
                                                  launches=3, batches=3, warmup=1)
                parts.append(f"{name} m={m}: y max abs diff {y_err:.3g}, gradients {g_err:.3g}"
                             f" of each leaf's largest")
                if not ok:
                    errors.append(f"19b: {name} at m={m} parts from the unsplit layer")
        ctx["tp_layer_counts"] = ops.launch_counts()
        ms = {kk: {a: round(b, 3) for a, b in v.items()} for kk, v in times.items()}
        log(f"19b the tensor-parallel layers' ranks in one process against the unsplit "
            f"layers, float32, TF32 off, x [2, 128, 2560]: {'; '.join(parts)}; forward + "
            f"backward device ms {json.dumps(ms)}; launches of the hand kernels "
            f"{ctx['tp_layer_counts']}")
        del layers, mlp_p, att_p, table, moe_p, x, xm
        torch.cuda.empty_cache()

        # (c) danube's full tree stored by the (data 2, model 4) plan: each
        # of the 8 ranks' shards, then the tree put back together bit for bit
        model = build_model(danube, "cuda")
        params = model.init(0)
        rules = make_rules(plan_mesh(8, global_batch=8, want_model=4), "train")
        shapes, axes = param_shapes(danube), param_axes(danube)
        t0 = time.perf_counter()
        layouts = [Sharded(rules, r, shapes, axes, None, None) for r in range(8)]
        shards = [lay.shard(params) for lay in layouts]
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        back_ok, bytes_ok, per_rank, table_bytes = True, True, [], []
        leaves = tree_leaves(params)
        shard_leaves = [tree_leaves(sh) for sh in shards]
        t0 = time.perf_counter()
        for i, g in enumerate(leaves):
            out = torch.empty_like(g)
            for lay, sh in zip(layouts, shard_leaves):
                out[tuple(lay.layouts[i].slices())] = sh[i]
            back_ok &= bool(torch.equal(out, g))
        torch.cuda.synchronize()
        back_s = time.perf_counter() - t0
        for lay, sh in zip(layouts, shard_leaves):
            got = sum(x.numel() * x.element_size() for x in sh)
            want = 0
            for ll, x in zip(lay.layouts, leaves):
                n = 1
                for dim, kept in zip(ll.shape, ll.spec):
                    n *= dim // int(np.prod([rules.sizes[a] for a in kept] or [1]))
                want += n * x.element_size()
            per_rank.append(got)
            table_bytes.append(want)
            bytes_ok &= got == want
        total = sum(x.numel() * x.element_size() for x in leaves)
        log(f"19c h2o-danube-1.8b's full tree ({total} bytes, bfloat16 with float32 norms) "
            f"stored by the (data 2, model 4) plan in this process: shards {shard_s:.2f} s, put "
            f"back together bit for bit {back_ok} ({back_s:.2f} s); bytes a rank {per_rank}, "
            f"the table's {table_bytes}")
        if not (back_ok and bytes_ok):
            errors.append(f"19c: shards put back {back_ok}, bytes as the table's {bytes_ok}")
        del params, shards, shard_leaves, layouts, leaves, model
        torch.cuda.empty_cache()
        for name in ("tp_counts", "tp_layer_counts"):
            if any(ctx.get(name, {}).values()):
                errors.append(f"19: a hand kernel launched on the path: {ctx[name]}")
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("19 tensor parallelism and sharded storage", phase_train_tp)

    def phase_train_tp_families():
        import torch.distributed as tdist
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.dist.compress import tree_leaves
        from repro_torch.dist.fsdp import Sharded
        from repro_torch.dist.sharding import make_rules
        from repro_torch.launch import summarize as launch
        from repro_torch.launch import train as train_lib
        from repro_torch.models import attention as attn
        from repro_torch.models import mamba2, tp_ranks, whisper, xlstm
        from repro_torch.models.api import build_model, param_axes, param_shapes
        from repro_torch.runtime import plan_mesh
        card = nvidia_smi("name,power.limit")
        errors, times, parts = [], {}, []
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        # (a) each new block's ranks at full width in this process
        # (models/tp_ranks.py) against the unsplit block, float32: forward
        # and the gradients of sum(y^2) within 19b's tolerance (rtol 2e-4,
        # atol 2e-5; a gradient's atol of its leaf's largest, attention's
        # bk, whose gradient is 0 in exact arithmetic, of the block's
        # largest). A chunked block's atols are at least 4 times its own
        # float32 noise, the unsplit block at half the chunk against it (the
        # same sums in another order): Mamba2's a_log and dt_bias gradients
        # add every position with cancellation (two chunkings part by about
        # 1e-4 of their largest on the CPU), and the mLSTM's normaliser
        # divides by |den|; on the card its split parts from the unsplit
        # block by about twice that noise
        def leaves(tree):
            if isinstance(tree, dict):
                return {kk: leaves(v) for kk, v in tree.items()}
            x = tree.detach().float().clone()
            if x.numel() > 1 and float(x.std()) == 0.0:  # constant at init
                x = x + 0.1 * torch.randn(x.shape, generator=gen, device=dev)
            return x.requires_grad_(True)

        def named(tree, prefix=""):
            if isinstance(tree, dict):
                return [t for kk, v in tree.items() for t in named(v, f"{prefix}/{kk}")]
            return [(prefix, tree)]

        def act(*shape):
            return torch.randn(shape, generator=gen, device=dev).requires_grad_(True)

        zamba = dataclasses.replace(get_config("zamba2_7b"), dtype="float32")
        xl = dataclasses.replace(get_config("xlstm_350m"), dtype="float32")
        wh = dataclasses.replace(get_config("whisper_large_v3"), dtype="float32")
        x_z, x_m, x_s = act(1, 512, zamba.d_model), act(2, 256, xl.d_model), act(2, 64, xl.d_model)
        x_e, x_d, enc = act(2, wh.enc_len, wh.d_model), act(2, 128, wh.d_model), act(
            2, wh.enc_len, wh.d_model)
        p_z = leaves(mamba2.init_mamba2(gen, zamba, torch.float32, dev))
        p_m = leaves(xlstm.init_mlstm(gen, xl, torch.float32, dev))
        p_s = leaves(xlstm.init_slstm(gen, xl, torch.float32, dev))
        p_e = leaves(whisper.init_enc_block(gen, wh, torch.float32, dev))
        p_d = leaves(whisper.init_dec_block(gen, wh, torch.float32, dev))
        enc_l = whisper.block_layers(wh, None, causal=False)
        dec_l = whisper.block_layers(wh, None, causal=True)
        # name: (split(m), whole(), the whole block at half the chunk or
        # None, inputs, leaves)
        blocks = {
            "zamba2-7b Mamba2 block (d 3584, 112 heads, x [1, 512, 3584]: 2 chunks)": (
                lambda m: tp_ranks.mamba2_block(p_z, x_z, zamba, m),
                lambda: mamba2.ssd_forward(p_z, x_z, zamba),
                lambda: mamba2.ssd_forward(p_z, x_z, zamba, chunk=128), [x_z], p_z),
            "xlstm-350m mLSTM block (d 1024, 4 heads, x [2, 256, 1024])": (
                lambda m: tp_ranks.mlstm_block(p_m, x_m, xl, m),
                lambda: xlstm.mlstm_forward(p_m, x_m, xl),
                lambda: xlstm.mlstm_forward(p_m, x_m, xl, chunk=128), [x_m], p_m),
            "xlstm-350m sLSTM block (4 heads, ff 2688, x [2, 64, 1024])": (
                lambda m: tp_ranks.slstm_block(p_s, x_s, xl, m),
                lambda: xlstm.slstm_forward(p_s, x_s, xl), None, [x_s], p_s),
            "whisper-large-v3 encoder block (20 heads, ff 5120, x [2, 1500, 1280])": (
                lambda m: tp_ranks.whisper_encoder_block(p_e, x_e, wh, m),
                lambda: whisper.enc_block(p_e, x_e, enc_l[0], enc_l[2]), None, [x_e], p_e),
            "whisper-large-v3 decoder block (x [2, 128, 1280], cross attention to 1500 "
            "frames)": (
                lambda m: tp_ranks.whisper_decoder_block(p_d, x_d, enc, wh, m),
                lambda: whisper.dec_block(p_d, x_d, enc, *dec_l), None, [x_d, enc], p_d),
        }

        def fwd_bwd(fn, ls):
            y = fn()
            return y.detach(), torch.autograd.grad((y.float() ** 2).sum(), ls)

        ops.reset_launch_counts()
        for name, (split, whole, alt, inputs, p) in blocks.items():
            names = [f"input{i}" for i in range(len(inputs))] + [nm for nm, _ in named(p)]
            ls = list(inputs) + [t for _, t in named(p)]
            y0, g0 = fwd_bwd(whole, ls)
            top = max(float(b.abs().max()) for b in g0)
            scale = [top if nm.endswith("/bk") else float(b.abs().max())
                     for nm, b in zip(names, g0)]
            y_atol = 2e-5
            if alt is not None:  # the block's own float32 noise, 4 times, where larger
                y_alt, g_alt = fwd_bwd(alt, ls)
                noise = [float((a - b).abs().max()) for a, b in zip(g_alt, g0)]
                log(f"20a {name}: the unsplit block at half the chunk against it, y "
                    f"{float((y_alt - y0).abs().max()):.3g}, gradients of each leaf's largest "
                    + ", ".join(f"{nm} {nz / float(b.abs().max()):.3g}"
                                for nm, nz, b in zip(names, noise, g0)))
                scale = [max(sc, 4 * nz / 2e-5) for sc, nz in zip(scale, noise)]
                y_atol = max(y_atol, 4 * float((y_alt - y0).abs().max()))
            times[name] = {"unsplit": time_cuda(torch, lambda: fwd_bwd(whole, ls), launches=2,
                                                batches=3, warmup=1)}
            for m in (2, 4):
                y, g = fwd_bwd(lambda: split(m), ls)
                y_err = float((y - y0).abs().max())
                errs = [float((a - b).abs().max()) / sc for a, b, sc in zip(g, g0, scale)]
                g_err = max(errs)
                worst = names[errs.index(g_err)]
                ok = torch.allclose(y, y0, rtol=2e-4, atol=y_atol) and all(
                    torch.allclose(a, b, rtol=2e-4, atol=2e-5 * sc)
                    for a, b, sc in zip(g, g0, scale))
                times[name][f"m={m}"] = time_cuda(torch, lambda: fwd_bwd(lambda: split(m), ls),
                                                  launches=2, batches=3, warmup=1)
                parts.append(f"{name} m={m}: y max abs diff {y_err:.3g} (largest |y| "
                             f"{float(y0.abs().max()):.3g}), gradients {g_err:.3g} of each "
                             f"leaf's scale (worst {worst})")
                if not ok:
                    errors.append(f"20a: {name} at m={m} parts from the unsplit block")
            del y0, g0
        ctx["tp_block_counts"] = ops.launch_counts()
        ms = {kk: {a: round(b, 3) for a, b in v.items()} for kk, v in times.items()}
        log(f"[{card}] 20a the new tensor-parallel blocks' ranks in one process against the "
            f"unsplit blocks, float32, TF32 off: {'; '.join(parts)}; forward + backward device "
            f"ms {json.dumps(ms)}; launches of the hand kernels {ctx['tp_block_counts']}")
        del blocks, p_z, p_m, p_s, p_e, p_d, x_z, x_m, x_s, x_e, x_d, enc
        torch.cuda.empty_cache()

        # (b) --want-model 2 in an NCCL group of one plans (1, 1): the
        # --want-model 1 run bit for bit, zamba2-7b (6 layers: one shared-
        # block site) and xlstm-350m (4 layers), full width, bfloat16
        launch.init_distributed(dev)  # NCCL, a world of one
        counts = {}
        try:
            for arch, n in (("zamba2_7b", 6), ("xlstm_350m", 4)):
                cut = dataclasses.replace(get_config(arch), n_layers=n)
                argv = ["--arch", arch, "--steps", "3", "--batch", "8", "--seq", "128",
                        "--device", "cuda", "--log-every", "100"]
                one = train_lib.train(train_lib.parse_args(argv), cfg=cut)
                one_params = [x.clone() for x in tree_leaves(one.params)]
                del one.params, one.opt, one.shards
                torch.cuda.empty_cache()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                run_tp = train_lib.train(train_lib.parse_args(argv + ["--want-model", "2"]),
                                         cfg=cut)
                wall = time.perf_counter() - t0
                counts[arch] = ops.launch_counts()
                same = run_tp.losses == one.losses and all(
                    torch.equal(a, b) for a, b in zip(tree_leaves(run_tp.params), one_params))
                res = run_tp.result
                log(f"[{card}] 20b {arch} full width, {n} bfloat16 layers, batch 8 x 128, 3 "
                    f"steps through repro_torch.launch.train --want-model 2 in an NCCL group of "
                    f"{res['world']} ({tdist.get_backend()}): mesh {res['mesh']}, {wall:.2f} s, "
                    f"median step {res['p50_step_s']:.4f} s, peak {res['peak_memory_bytes']} "
                    f"bytes; losses {[round(x, 6) for x in run_tp.losses]}; equal to the "
                    f"--want-model 1 run bit for bit {same}; launches of the hand kernels "
                    f"{counts[arch]}")
                if not same or res["mesh"] != {"data": 1, "model": 1}:
                    errors.append(f"20b: {arch} at --want-model 2 differs (mesh {res['mesh']})")
                del run_tp, one_params, one
                torch.cuda.empty_cache()
        finally:
            tdist.destroy_process_group()
        ctx["tp_families_counts"] = {k: sum(c[k] for c in counts.values())
                                     for k in next(iter(counts.values()))}

        # (c) zamba2-7b's full tree by the (data 2, model 4) plan: the bytes
        # of each model rank's views (its model part of every leaf, gathered
        # over the data ranks and held for the step) against the whole-leaf
        # views every model rank held before the blocks split; the transient
        # whole leaves a step gathers one at a time, counted apart
        full = get_config("zamba2_7b")
        small = dataclasses.replace(get_smoke_config("zamba2_7b"), n_layers=full.n_layers,
                                    attn_every=full.attn_every, dtype="bfloat16")
        elem = [x.element_size() for x in tree_leaves(build_model(small, "cpu").init(0))]
        shapes, axes = param_shapes(full), param_axes(full)
        rules = make_rules(plan_mesh(8, global_batch=8, want_model=4), "train")
        whole_bytes = None
        views = []
        for r in range(8):
            lays = Sharded(rules, r, shapes, axes, None, None).layouts
            views.append(sum(int(np.prod(lay.shape)) // lay.model_parts * e
                             for lay, e in zip(lays, elem)))
            whole_bytes = sum(int(np.prod(lay.shape)) * e for lay, e in zip(lays, elem))
        d, di, h, _, n = mamba2.dims(full)
        in_proj = d * (2 * di + 2 * n + h) * 2
        qkv = 3 * d * full.n_heads * full.hd * 2
        log(f"20c zamba2-7b's full tree ({whole_bytes} bytes) by the (data 2, model 4) plan, "
            f"from the train table: each model rank's views {views} bytes "
            f"({views[0] / whole_bytes:.4f} of the whole-leaf views every model rank held "
            f"before); transient, one at a time: a Mamba2 block's in_proj gathered whole "
            f"{in_proj} bytes (freed before its products), the shared block's wq/wk/wv "
            f"gathered whole {qkv} bytes; views + one in_proj {views[0] + in_proj} bytes")
        if len(set(views)) != 1 or not views[0] < whole_bytes / 3:
            errors.append(f"20c: views {views} against {whole_bytes}")
        for name in ("tp_block_counts", "tp_families_counts"):
            if any(ctx.get(name, {}).values()):
                errors.append(f"20: a hand kernel launched on the path: {ctx[name]}")
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("20 tensor-parallel compute of the other families", phase_train_tp_families)

    # ---- 21. serving across ranks: the serve table and the split decode ----
    def phase_serve_ranks():
        import torch.distributed as tdist
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.dist.compress import tree_leaves
        from repro_torch.dist.fsdp import Sharded
        from repro_torch.dist.sharding import make_rules
        from repro_torch.launch import serve as serve_lib
        from repro_torch.launch import summarize as launch
        from repro_torch.models import transformer, whisper
        from repro_torch.models.api import build_model, param_axes, param_shapes
        from repro_torch.models.tp_ranks import DecodeRanks
        from repro_torch.runtime import plan_mesh
        card = nvidia_smi("name,power.limit")
        errors = []
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on for float32 matmuls")
        qwen = get_config("qwen2_5_14b")

        # (a) the launcher in an NCCL group of one, through the bootstrap's
        # flags: 8 of qwen2.5-14B's 48 bfloat16 layers (the depth cut for the
        # time limit), 8 slots; the tokens of BatchServer without a group
        cut = dataclasses.replace(qwen, n_layers=SERVE_RANKS_LAYERS)
        model = build_model(cut, dev)
        params = model.init(0)
        port = free_port()
        argv = ["--arch", "qwen2_5_14b", "--slots", "8", "--requests", "8", "--prompt-len",
                "16", "--gen-len", "16", "--max-len", "64", "--device", "cuda",
                "--coordinator", f"localhost:{port}", "--num-processes", "1",
                "--process-id", "0"]
        launch.init_distributed(dev)  # NCCL, a world of one
        try:
            backend = tdist.get_backend()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            res, launched = serve_lib.serve(serve_lib.parse_args(argv), params, cfg=cut)
            torch.cuda.synchronize()
            ctx["serve_ranks_counts"] = ops.launch_counts()
        finally:
            tdist.destroy_process_group()
        args = serve_lib.parse_args(argv)
        plain = serve_lib.BatchServer(cut, slots=8, max_len=64, params=params, device=dev)
        rng = np.random.default_rng(args.seed)
        for rid in range(args.requests):
            plain.submit(serve_lib.Request(rid=rid, prompt=rng.integers(
                0, cut.vocab, args.prompt_len).astype(np.int32), max_new=args.gen_len))
        while plain.step():
            pass
        got = {r.rid: list(r.out) for r in launched.done}
        want = {r.rid: list(r.out) for r in plain.done}
        same = got == want and all(torch.equal(a, b) for a, b in zip(
            tree_leaves(launched.cache), tree_leaves(plain.cache)))
        log(f"[{card}] 21a qwen2.5-14B full width, {cut.n_layers} of 48 bfloat16 layers, "
            f"repro_torch.launch.serve in an NCCL group of one ({backend}) through "
            f"--coordinator/--num-processes 1/--process-id 0: plan {res['plan']}, "
            f"{res['requests']} requests, {res['tokens']} tokens, {res['decode_steps']} decode "
            f"steps, median step {res['p50_decode_step_s'] * 1e3:.3f} ms, "
            f"{res['tok_per_s']:.1f} tokens/s; tokens and cache equal to BatchServer without "
            f"a group bit for bit {same}; launches of the hand kernels "
            f"{ctx['serve_ranks_counts']}")
        if not same or res["plan"] != {"data": 1, "model": 1} or res["world"] != 1:
            errors.append(f"21a: the launcher in a group of one differs (plan {res['plan']})")
        if any(ctx["serve_ranks_counts"].values()):
            errors.append(f"21a: hand kernels launched on the LM path "
                          f"{ctx['serve_ranks_counts']}")
        # a data rank decodes its block of slots alone: the same step on 2
        # of the 8 slots against those slots of the 8-slot step (bfloat16
        # products of another shape may round otherwise; not asserted)
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        token = torch.randint(0, cut.vocab, (8,), device=dev, generator=gen)
        pos = torch.arange(8, device=dev) * 7
        with torch.no_grad():
            all8, _ = model.serve_step(params, {"token": token, "pos": pos,
                                                "cache": model.init_cache(8, 64)})
            two, _ = model.serve_step(params, {"token": token[:2], "pos": pos[:2],
                                               "cache": model.init_cache(2, 64)})
        log(f"21a a bfloat16 step of slots [0, 2) alone against the 8-slot step: equal bit "
            f"for bit {torch.equal(two, all8[:2])}, max |difference| / max |logit| "
            f"{float((two - all8[:2]).abs().max() / all8[:2].abs().max()):.3e}, greedy ids "
            f"equal {torch.equal(two.argmax(-1), all8[:2].argmax(-1))}")
        del model, params, launched, plain
        torch.cuda.empty_cache()

        # (b, c, e, f, g) the split decode step at full width, float32: m
        # model ranks as threads of this process (models/tp_ranks.py) against
        # the unsplit step on the card, 8 slots at spread positions; no hand
        # kernel launched on these paths. ``fill(model, params, cache)``
        # fills a cache before the steps (whisper's cross K/V)
        ctx["split_decode_counts"] = {}

        def split_decode(tag, cfg, variants, fill=None):
            model = build_model(cfg, dev)
            params = model.init(0)
            gen = torch.Generator(device=dev)
            gen.manual_seed(1)
            slots, steps = 8, 6
            for size, max_len in variants:
                cache = model.init_cache(slots, max_len)
                if fill is not None:
                    fill(model, params, cache)
                ranks = DecodeRanks(model, params, slots, max_len, size, cache=cache)
                ops.reset_launch_counts()
                stride = (max_len - steps) // slots
                worst = 0.0
                for t in range(steps):
                    token = torch.randint(0, cfg.vocab, (slots,), device=dev, generator=gen)
                    pos = torch.arange(slots, device=dev) * stride + t
                    with torch.no_grad():
                        want, cache = model.serve_step(params, {"token": token, "pos": pos,
                                                                "cache": cache})
                    got = ranks.step(token, pos)
                    worst = max(worst, float((got - want).abs().max() / want.abs().max()))
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                for k, n in counts.items():
                    ctx["split_decode_counts"][k] = ctx["split_decode_counts"].get(k, 0) + n
                if any(counts.values()):
                    errors.append(f"{tag} m={size}: hand kernels launched {counts}")
                state = {"cache": cache}

                def whole_step():
                    with torch.no_grad():
                        _, state["cache"] = model.serve_step(
                            params, {"token": token, "pos": pos, "cache": state["cache"]})

                split_ms = time_cuda(torch, lambda: ranks.step(token, pos), launches=5,
                                     batches=3)
                whole_ms = time_cuda(torch, whole_step, launches=5, batches=3)
                names = {1: "positions (kvseq)", 2: "KV heads", None: "none (whole)"}
                split = ("none (no KV cache; states on heads)" if cfg.family == "xlstm"
                         else names[ranks.kv_split()])
                log(f"[{card}] {tag} m={size} max_len={max_len}: KV cache split on "
                    f"{split}; max |split - unsplit| / max |logit| over "
                    f"{steps} steps {worst:.3e} (limit {SPLIT_DECODE_TOL:g}); step "
                    f"{split_ms:.3f} ms split ({size} ranks in one process) against "
                    f"{whole_ms:.3f} ms unsplit (CUDA events, 5 steps back to back)")
                profiled(torch, lambda: (ranks.step(token, pos), torch.cuda.synchronize()),
                         f"[{card}] {tag} m={size} max_len={max_len}", "split decode step", 3)
                if not worst <= SPLIT_DECODE_TOL:
                    errors.append(f"{tag} m={size} max_len={max_len}: {worst:.3e}")
                ranks.close()
                del ranks, cache, state
                torch.cuda.empty_cache()
            del model, params
            torch.cuda.empty_cache()

        # max_len 512 at m = 2, 4 (the positions split), 510 at m = 4 (the 8
        # KV heads split)
        split_decode("21b qwen2.5-14B full width, 2 float32 layers",
                     dataclasses.replace(qwen, n_layers=2, dtype="float32"),
                     [(2, 512), (4, 512), (4, 510)])
        granite = get_config("granite_moe_3b_a800m")
        split_decode("21c granite-moe-3b-a800m full width, 2 float32 layers",
                     dataclasses.replace(granite, n_layers=2, dtype="float32"),
                     [(2, 512), (4, 512)])

        # (e) zamba2-7b, 6 of its 81 layers (attention site 5 in), (f)
        # xlstm-350m, 4 of its 24 layers, (g) whisper-large-v3, 2 decoder
        # layers (no encoder layer: the cross K/V come from a seeded encoder
        # output through fill_cross_cache); max_len 512 at m = 2, 4 (the
        # positions split), 510 at m = 4 (the KV heads)
        split_decode("21e zamba2-7b full width, 6 float32 layers",
                     dataclasses.replace(get_config("zamba2_7b"), n_layers=6, dtype="float32"),
                     [(2, 512), (4, 512)])
        split_decode("21f xlstm-350m full width, 4 float32 layers",
                     dataclasses.replace(get_config("xlstm_350m"), n_layers=4, dtype="float32"),
                     [(2, 512), (4, 512)])
        wcfg = dataclasses.replace(get_config("whisper_large_v3"), n_layers=2, enc_layers=0,
                                   dtype="float32")

        def cross(model, params, cache):
            g = torch.Generator(device=dev)
            g.manual_seed(3)
            enc = torch.randn(cache["dec_0"]["xk"].shape[0], wcfg.enc_len, wcfg.d_model,
                              generator=g, device=dev)
            whisper.fill_cross_cache(params, cache, enc, wcfg)

        split_decode("21g whisper-large-v3 full width, 2 float32 decoder layers, the cross "
                     "K/V from a seeded encoder output", wcfg, [(2, 512), (4, 512), (4, 510)],
                     cross)

        # (d) a qwen2.5-14B rank's stored bytes at (1, 4), 48 layers, a cache
        # of 8 slots x 4096, reckoned from the shapes the serve table gives
        rules = make_rules(plan_mesh(4, global_batch=8, want_model=4), "serve")
        itemsize = {torch.bfloat16: 2, torch.float32: 4}
        small = dataclasses.replace(get_smoke_config("qwen2_5_14b"), n_layers=qwen.n_layers,
                                    dtype=qwen.dtype, tie_embeddings=qwen.tie_embeddings,
                                    qkv_bias=qwen.qkv_bias)
        dtypes = [itemsize[x.dtype] for x in tree_leaves(build_model(small, "cpu").init(0))]
        whole = transformer.init_cache(qwen, 8, 4096, torch.bfloat16, "meta")
        cache_shapes = {k: {n: tuple(x.shape) for n, x in v.items()} for k, v in whole.items()}
        per_rank = []
        for r in range(4):
            fs = Sharded(rules, r, param_shapes(qwen), param_axes(qwen), None, None)
            cs = Sharded(rules, r, cache_shapes, transformer.cache_axes(qwen), None, None)
            if len(dtypes) != len(fs.layouts):
                raise AssertionError(f"{len(dtypes)} leaf types for {len(fs.layouts)} leaves")
            p_bytes = sum(int(np.prod(s)) * e for s, e in zip(fs.local_shapes(), dtypes))
            c_bytes = sum(int(np.prod(s)) * 2 for s in cs.local_shapes())
            per_rank.append((p_bytes, c_bytes))
        p_whole = sum(int(np.prod(lay.shape)) * e for lay, e in zip(fs.layouts, dtypes))
        c_whole = transformer.kv_cache_bytes(qwen, 8, 4096)
        log(f"21d qwen2.5-14B at (1, 4), 48 bfloat16 layers, 8 slots x 4096: parameters "
            f"{p_whole} bytes whole, a rank's {[p for p, _ in per_rank]}; KV cache {c_whole} "
            f"bytes whole, a rank's {[c for _, c in per_rank]} (split on "
            f"{cs.layouts[0].spec})")
        if c_whole != 6_442_450_944 or any(c != c_whole // 4 for _, c in per_rank):
            errors.append(f"21d: cache bytes {c_whole}, a rank's {per_rank}")
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("21 serving across ranks", phase_serve_ranks)

    # ---- 22. the dry-run (launch/costs.py, lowering.py) against the card ----
    def phase_dryrun():
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.configs import SHAPES, get_config
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch import costs as dry_costs
        from repro_torch.launch.lowering import (build_cell, production_plan, trace_cell,
                                                 tree_leaves_any)
        from repro_torch.runtime import plan_mesh

        errors = []
        # (a) the analytic kernel costs give phases 2 and 3's bytes bounds
        g, c, u, want2 = ctx["merge_gain_bound"]
        e, want3 = ctx["pair_cost_bound"]
        got2 = dry_costs.merge_gain_bytes(g, c, u) / H100.hbm_bytes_per_s * 1e3
        got3 = dry_costs.pair_cost_bytes(e) / H100.hbm_bytes_per_s * 1e3
        log(f"22a the dry-run's kernel costs: merge_gain bytes bound {got2:.4f} ms (phase 2: "
            f"{want2:.4f}), pair_cost {got3:.4f} ms (phase 3: {want3:.4f})")
        if got2 != want2 or got3 != want3:
            errors.append(f"22a: {got2!r} against {want2!r}, {got3!r} against {want3!r}")

        # (b) two cells run for real at a world of one, each against its
        # trace on meta: FlopCounterMode's count, the stored and peak bytes
        ops.reset_launch_counts()
        cells = (("h2o-danube-1.8b, 2 bfloat16 layers, train 8 x 128, remat",
                  dataclasses.replace(get_config("h2o_danube_1_8b"), n_layers=2),
                  ShapeSpec("chip_train", 128, 8, "train")),
                 ("qwen2.5-14B, 2 bfloat16 layers, decode 8 slots x 4096",
                  dataclasses.replace(get_config("qwen2_5_14b"), n_layers=2),
                  ShapeSpec("chip_decode", 4096, 8, "decode")))
        for what, cfg, sp in cells:
            plan = plan_mesh(1, global_batch=sp.global_batch, want_model=1)
            t0 = time.perf_counter()
            meta = trace_cell(build_cell(cfg, sp, plan))
            meta_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            cell = build_cell(cfg, sp, plan, device="cuda")
            leaves = tree_leaves_any(cell.args)
            if any(x.device.type != "cuda" for x in leaves):
                raise AssertionError(f"22b {what}: an argument is not on the card")
            stored = dry_costs.WorkCounter("cuda").add_storages(leaves)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fc = FlopCounterMode(display=False)
            t0 = time.perf_counter()
            with fc:
                out = cell.step_fn(*cell.args)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            flops = fc.get_total_flops()
            result = out[3]["loss"] if sp.kind == "train" else out[0]
            finite = bool(torch.isfinite(result).all())
            predicted = meta["memory"]["argument_bytes"] + meta["memory"]["temp_bytes"]
            ratio = predicted / peak
            log(f"22b {what}: FlopCounterMode on the card {flops} FLOPs, the trace on meta "
                f"{meta['cost']['flops']:.0f} ({meta_s:.1f} s); arguments predicted "
                f"{meta['memory']['argument_bytes']} bytes, stored {stored}; peak predicted "
                f"{predicted} bytes, torch.cuda.max_memory_allocated {peak} above the "
                f"arguments' start, ratio {ratio:.4f}; output finite {finite}, step "
                f"{step_s * 1e3:.1f} ms (first call, counted); meta bytes_accessed "
                f"{meta['cost']['bytes_accessed']:.0f}")
            if flops != meta["cost"]["flops"]:
                errors.append(f"22b {what}: {flops} FLOPs on the card, "
                              f"{meta['cost']['flops']} on meta")
            if stored != meta["memory"]["argument_bytes"]:
                errors.append(f"22b {what}: stored {stored}, predicted "
                              f"{meta['memory']['argument_bytes']}")
            if not 0.5 <= ratio <= 2.0 or not finite:
                errors.append(f"22b {what}: peak ratio {ratio:.4f}, finite {finite}")
            del out, cell, leaves, result
            torch.cuda.empty_cache()
        ctx["dryrun_counts"] = ops.launch_counts()

        # (c) one production cell on meta, on this host
        sp = SHAPES["decode_32k"]
        t0 = time.perf_counter()
        rec = trace_cell(build_cell(get_config("qwen2_5_14b"), sp,
                                    production_plan("pod", sp.global_batch)))
        rf = rec["roofline"]
        log(f"22c qwen2.5-14B decode_32k on the pod plan (16, 16), rank 0 on meta: "
            f"{time.perf_counter() - t0:.1f} s (trace {rec['trace_s']:.1f} s); "
            f"t_compute {rf['t_compute']:.3e} s, t_memory {rf['t_memory']:.3e} s, "
            f"t_collective {rf['t_collective']:.3e} s ({rf['bottleneck']}), arguments "
            f"{rec['memory']['argument_bytes']} bytes a rank")
        if errors:
            raise AssertionError("; ".join(errors))

    smoke.phase("22 the dry-run against the card", phase_dryrun)

    if smoke.failed:
        log(f"chip_smoke: failed phases: {smoke.failed}")
        return 1
    names = ("merge_gain", "pair_cost", "segment_sum", "ordered_sum")
    for k in names:
        if "launches" not in smoke.kernels.get(k, {}):
            log(f"chip_smoke: no numbers for {k}")
            return 1
        by_path = smoke.kernels[k].setdefault("launches_by_path", {})
        by_path["summarize"] = ctx["main_counts"][k]
        by_path["queries"] = ctx["serve_counts"][k]
        by_path.setdefault("edge-sharded", 0)
        by_path["baselines comparison, SSumM side"] = ctx["baseline_counts"][k]
        by_path["MoE serving (granite, phase 14b)"] = ctx["moe_counts"][k]
        by_path["hybrid serving (zamba2, phase 15b)"] = ctx["hybrid_counts"][k]
        by_path["xLSTM serving (phase 15c)"] = ctx["xlstm_counts"][k]
        by_path["VLM prefill (paligemma, phase 15d)"] = ctx["vlm_counts"][k]
        by_path["whisper serving (phase 16b)"] = ctx["whisper_counts"][k]
        by_path["training (danube, phase 17b)"] = ctx["train_counts"][k]
        by_path["training in an NCCL group of one (danube, phase 18a)"] = ctx["dp_counts"][k]
        by_path["MoE training (granite, phase 18b)"] = ctx["moe_train_counts"][k]
        by_path["expert-parallel MoE block (phase 18c)"] = ctx["a2a_counts"][k]
        by_path["training at --want-model 2 (danube, phase 19a)"] = ctx["tp_counts"][k]
        by_path["training at --want-model 2 (zamba2, xLSTM, phase 20b)"] = ctx[
            "tp_families_counts"][k]
        by_path["serving in an NCCL group of one (qwen2.5-14B, phase 21a)"] = ctx[
            "serve_ranks_counts"][k]
        by_path["split decode steps, every family (phase 21b-c, e-g)"] = ctx[
            "split_decode_counts"].get(k, 0)
        by_path["the dry-run's cells on the card (phase 22b)"] = ctx["dryrun_counts"][k]
    log(json.dumps({"kernels": [smoke.kernels[k] for k in names]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="chip-smoke-")
    try:
        return run(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
