#!/usr/bin/env python3
"""Smoke test of repro_torch (the PyTorch port of SSumM) on one NVIDIA card.

    python3 chip_smoke.py

Builds both hand kernels from this checkout's sources, holds each against
its plain PyTorch version (the merge gain's on CPU copies of the card's
operands, where it adds and takes log2 as the reference does; the pair
cost's on the card), drives the port's main path
(``repro_torch.core.summarize``) on the skitter stand-in at full size
(V = 2,097,152, E = 11,095,298) with the default config, and compares card
and CPU runs on a small graph. Phases, one line each:

  1. device: the card's name and power limit, CUDA, the kernels' build time;
  2. merge_gain (CUDA) against plain: test shapes, C=64/U=256 (shared-memory
     opt-in), every group of the real round-1 tables; the dense case's time;
     argmax tie rules;
  3. pair_cost (Triton) against plain: E in {7, 1025, 5000} and the real
     pair table;
  4. the main path at full size: budget met, metrics finite, each kernel
     launched once per round; then one round replayed stage by stage, and
     once under torch.profiler, to show where its time goes;
  5. card against CPU on the golden fixture, with the same permutations.

Kernel times are device times: a batch of launches back to back between
one pair of CUDA events, over the count. Then one JSON line of per-kernel
numbers, and as the last line
``{"ok": true, "device": {...}}``. Exits non-zero, and prints no result
line, when CUDA is unavailable, when the package is missing, or when any
phase fails. Imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores (data sheet)
SFU_PER_SM_PER_CLK = 16
NUM_SMS = 132

# Per entropy term f(cnt, pi) with cnt > 0: two log2 and one division on the
# special-function units, and about 24 other float32 operations. A term with
# cnt == 0 is 0 and needs neither. merge_gain adds one division (rel) per
# ordered live pair.
SFU_PER_TERM = 3
FLOPS_PER_TERM = 24

RTOL = 1e-5
ATOL_RED = 1e-3
ATOL_REL = 1e-4


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


def profiled_ms(torch, fn, kernel: str, launches: int = 20):
    """Mean device time, in ms, of the kernels whose name holds ``kernel``
    over ``launches`` calls of ``fn`` under torch.profiler; None when the
    profiler records no such kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA" and kernel in e.key]
    except RuntimeError:
        return None
    count = sum(e.count for e in events)
    return sum(e.self_device_time_total for e in events) / 1e3 / count if count else None


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


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


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


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    try:
        from repro_torch.core import costs, merge, shingles, summarize, tables
        from repro_torch.core.convert import ReplayPermutations
        from repro_torch.core.engine import LocalBackend
        from repro_torch.core.types import SummaryConfig, init_state, make_graph
        from repro_torch.graphs import generate
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels.entropy_bits import pair_cost_triton
        from repro_torch.kernels import merge_gain as merge_gain_lib
        from repro_torch.kernels.merge_gain import merge_gain_cuda
        from repro_torch.utils import f32math
    except ImportError as exc:
        print(f"chip_smoke: cannot import repro_torch ({exc}); run it from the "
              "root of the repository", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smoke = Smoke()
    ctx: dict = {}

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
        errs = []
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
                check_gain_shape(got)
        log(f"merge_gain test shapes {shapes} x sparse/dense: max abs err {max(errs):.3g}")

        # every group of the real round-1 tables, 512 groups at a time
        gt, scal = ctx["gt"], ctx["scal"]
        g_all, c, u = gt.m.shape
        full = (gt.m, gt.n, gt.s, gt.t, gt.n_u, gt.cidx, gt.w, scal)
        got = merge_gain_cuda(*full)
        check_gain_shape(got)
        err_real = 0.0
        t0 = time.perf_counter()
        for lo in range(0, g_all, 512):
            chunk = [x[lo:lo + 512] for x in full[:7]]
            err_real = max(err_real, gain_error(
                (got[0][lo:lo + 512], got[1][lo:lo + 512]),
                plain_gain_cpu(ref, chunk, scal)))
        cpu_s = time.perf_counter() - t0
        valid = int(torch.isfinite(got[0]).sum())
        del got
        nz = gt.m != 0
        row_nnz = nz.sum(-1)
        full_words = int(nz.reshape(g_all, c, -1, 32).all(-1).sum()) if u % 32 == 0 else 0
        log(f"merge_gain on all G={g_all} real groups against the plain version on "
            f"the CPU ({cpu_s:.0f} s): max abs err {err_real:.3g}; "
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
            max_abs_err=max(errs + [err_real, err_dense]), ms=ms, plain_ms=plain_ms,
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
        peak = torch.cuda.max_memory_allocated()
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
        if counts != {"merge_gain": res.iterations_run, "pair_cost": res.iterations_run}:
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
        log(f"later rounds (not asserted; float atomics on the card): {len(hc)} CPU "
            f"rounds, {len(hg)} card rounds, integer stats agree in "
            f"{sum(same)}/{min(len(hc), len(hg))}, first difference at round "
            f"{first_diff}; final supernodes CPU {runs['cpu'].num_supernodes} card "
            f"{runs['cuda'].num_supernodes}, size_bits CPU {runs['cpu'].size_bits} "
            f"card {runs['cuda'].size_bits}")

    smoke.phase("5 card vs CPU", phase_card_vs_cpu)

    if smoke.failed:
        log(f"chip_smoke: failed phases: {smoke.failed}")
        return 1
    for k in ("merge_gain", "pair_cost"):
        if "launches" not in smoke.kernels.get(k, {}):
            log(f"chip_smoke: no numbers for {k}")
            return 1
    log(json.dumps({"kernels": [smoke.kernels["merge_gain"], smoke.kernels["pair_cost"]]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
