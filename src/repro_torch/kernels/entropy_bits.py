"""Pair-cost kernel (Triton) and its launcher: the Eq. 11/12 cost per pair.

Replaces ``repro/kernels/entropy_bits.py::pair_cost_pallas`` (Pallas body
``_pair_cost_kernel``)::

    out = min(cbar + H(cnt, pi), 2·cnt·log2v)  where cnt > 0, else 0
    H   = -pi·(σlog₂σ + (1-σ)log₂(1-σ)),  σ = clip(cnt / max(pi, 1), 0, 1)

The port runs it over the E-row pair table once a round, where the reference
computes the same function with jnp (``repro/core/costs.py:239``,
``supernode_total_costs``).

What bounds it on this card: one fused elementwise pass, 12 bytes moved per
element (cnt and pi read, out written), no reuse and no reduction, so the
bytes bound it (12·E bytes over 3.35 TB/s). Each element also takes two
libdevice log2 and an IEEE division, about a hundred instructions, so its
issue time is close to its memory time; the resident programs of an SM
overlap the one's loads with the other's arithmetic. Every operation is
float32, as in the plain version. The ragged end of E is masked, so no
padding copy is made (``pair_cost_pallas`` pads to a multiple of 1024).
``cbar`` and ``log2v`` are loaded from a device tensor, so passing them
needs no host sync. log2 comes from libdevice and the division rounds as
IEEE, to stay within the reference's tolerances.

``triton`` is imported, and the kernel compiled, inside :func:`pair_cost_triton`
at its first call: this module imports on a machine without ``triton``.
``pair_cost_triton.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

BLOCK = 1024
NUM_WARPS = 4

_KERNEL = []  # the jitted kernel, compiled at first launch


def _pair_cost_kernel(cnt_ptr, pi_ptr, scal_ptr, out_ptr, e, BLOCK: tl.constexpr):
    # `tl` and `libdevice` are names in this module's globals, bound by _jit()
    # when the kernel is first compiled.
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    live = offs < e
    cnt = tl.load(cnt_ptr + offs, mask=live, other=0).to(tl.float32)
    pi = tl.load(pi_ptr + offs, mask=live, other=0).to(tl.float32)
    cbar = tl.load(scal_ptr)
    log2v = tl.load(scal_ptr + 1)
    # the plain version's clamp, 1e-38 rounded to float32: Triton types the
    # bare literal, below float32's smallest normal, as float64, and would
    # take the log2 terms in float64
    tiny = tl.full([BLOCK], 1e-38, tl.float32)
    safe_pi = tl.maximum(pi, 1.0)
    sigma = tl.minimum(tl.maximum(tl.fdiv(cnt, safe_pi, ieee_rounding=True), 0.0),
                       1.0)
    xlogx = tl.where(sigma > 0.0, sigma * libdevice.log2(tl.maximum(sigma, tiny)), 0.0)
    one_m = 1.0 - sigma
    ylogy = tl.where(sigma < 1.0, one_m * libdevice.log2(tl.maximum(one_m, tiny)), 0.0)
    ent = tl.where((pi > 0.0) & (cnt > 0.0) & (cnt < pi),
                   -pi * (xlogx + ylogy), 0.0)
    c1 = cbar + ent
    c2 = 2.0 * cnt * log2v
    out = tl.where(cnt > 0.0, tl.minimum(c1, c2), 0.0)
    tl.store(out_ptr + offs, out, mask=live)


def _jit():
    if not _KERNEL:
        import triton
        import triton.language as tl

        try:  # triton >= 3.1 keeps libdevice here; 3.0 under extra.cuda
            from triton.language.extra import libdevice
        except ImportError:
            from triton.language.extra.cuda import libdevice
        globals().update(tl=tl, libdevice=libdevice)
        _KERNEL.append(triton.jit(_pair_cost_kernel))
    return _KERNEL[0]


def pair_cost_triton(cnt: torch.Tensor, pi: torch.Tensor,
                     scal: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream; returns f32[E].

    ``cnt`` and ``pi`` are 1-D, float32 or int32 (cast to float32 in the
    kernel); ``scal`` is a device tensor ``f32[2] = (cbar, log2v)``.
    """
    dev = cnt.device
    if dev.type != "cuda":
        raise ValueError(f"pair_cost_triton needs CUDA tensors, got {dev}")
    for name, x in (("cnt", cnt), ("pi", pi)):
        if x.device != dev or x.dim() != 1 or x.shape != cnt.shape \
                or x.dtype not in (torch.float32, torch.int32) \
                or not x.is_contiguous():
            raise ValueError(
                f"pair_cost_triton: {name} must be a contiguous 1-D float32 or "
                f"int32 tensor of shape {tuple(cnt.shape)} on {dev}; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if scal.device != dev or scal.dtype != torch.float32 or tuple(scal.shape) != (2,):
        raise ValueError("pair_cost_triton: scal must be f32[2] on the same device")
    e = cnt.shape[0]
    out = torch.empty(e, dtype=torch.float32, device=dev)
    if e == 0:
        return out
    kernel = _jit()
    with torch.cuda.device(dev):
        # enable_fp_fusion=False: no multiply-add contraction, each operation
        # rounds on its own as in the plain version
        kernel[((e + BLOCK - 1) // BLOCK,)](cnt, pi, scal, out, e, BLOCK=BLOCK,
                                            num_warps=NUM_WARPS,
                                            enable_fp_fusion=False)
    pair_cost_triton.launches += 1
    return out


pair_cost_triton.launches = 0
