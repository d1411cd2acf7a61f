"""The yardstick of the kernels' roofline shares: the card's published rates
and the work each launch of a hand kernel needs on its operands.

A launch's bound is the larger of two terms:

* bytes: every operand read once and every output written once, from the
  shapes and element sizes, at the HBM rate;
* compute: the entropy terms the operands need, each two ``log2`` and one
  division on the special-function units (SFU) and about 24 other float32
  operations, at the SFU and float32 rates. A term whose count is 0 is 0 and
  needs neither.

The work counts are copies of the repository's own (``chip_smoke.py``:
``merge_gain_work`` and the pair cost's live rows), kept here so that a
change to the program cannot move the yardstick.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rates:
    """Published peaks of one card (NVIDIA's data sheet, SXM part, at its
    700 W power limit and the 1,980 MHz maximum SM clock)."""

    name: str
    hbm_bytes_per_s: float
    fp32_flops: float  # outside the tensor cores
    num_sms: int
    sfu_per_sm_per_clk: int
    sm_clock_hz: float

    @property
    def sfu_per_s(self) -> float:
        return self.num_sms * self.sfu_per_sm_per_clk * self.sm_clock_hz


H100_SXM = Rates(name="NVIDIA H100 SXM 80GB (data sheet)", hbm_bytes_per_s=3.35e12,
                 fp32_flops=67e12, num_sms=132, sfu_per_sm_per_clk=16,
                 sm_clock_hz=1.98e9)

#: SFU results and other float32 operations of one entropy term
SFU_PER_TERM = 3
FLOPS_PER_TERM = 24


def bound_s(nbytes: float, terms: float, extra_sfu: float = 0.0,
            rates: Rates = H100_SXM) -> float:
    """The least time a launch can take: bytes at the HBM rate, or its SFU
    results or float32 operations at theirs, whichever is longest."""
    t_bytes = nbytes / rates.hbm_bytes_per_s
    t_sfu = (terms * SFU_PER_TERM + extra_sfu) / rates.sfu_per_s
    t_flops = terms * FLOPS_PER_TERM / rates.fp32_flops
    return max(t_bytes, t_sfu, t_flops)


def merge_gain_bytes(g: int, c: int, u: int, elem: int = 4) -> int:
    """Operands m [G,C,U], n, s, t, cidx [G,C], n_u [G,U], w [G,C,C] read once;
    rel and red [G,C,C] written once; every element 4 bytes."""
    return g * (c * u + 3 * c * c + 4 * c + u) * elem


def merge_gain_work(torch, m, n, s, w):
    """(entropy terms, ordered live pairs) that the merge gain needs on these
    operands, as 0-d float64 tensors on their device (no host sync): a term
    for each nonzero entry of m[i] + m[j] over live pairs i < j (the cross
    sum is symmetric in i, j), for each nonzero of a live member's row m[i]
    and self count s[i], and for each live pair's nonzero merged self count
    and w. Every ordered live pair adds one division (rel)."""
    c = m.shape[1]
    live = n > 0
    nz = (m > 0) & live[..., None]
    nz_row = nz.sum(-1).double()
    n_live = live.sum(-1).double()
    k = nz.sum(1).double()  # live members with a nonzero in each column
    # m >= 0, so nz(m[i] + m[j]) is the union of the two rows' nonzeros:
    # summed over i < j, (L - 1)·Σ|nz_i| − Σ_u k_u(k_u − 1)/2
    cross = ((n_live - 1).clamp(min=0) * nz_row.sum(-1)).sum() - (k * (k - 1) / 2).sum()
    pairs = live[:, :, None] & live[:, None, :]
    upper = pairs & torch.ones(c, c, dtype=torch.bool, device=m.device).triu(1)
    s_m = s[:, :, None] + s[:, None, :] + w
    epilogue = ((s_m > 0) & upper).sum().double() + ((w > 0) & upper).sum().double()
    rows = nz_row.sum() + ((s > 0) & live).sum().double()
    return cross + rows + epilogue, 2 * upper.sum().double()


def pair_cost_bytes(cnt, pi, out) -> int:
    """cnt and pi read once, the cost written once (12 bytes a row in float32)."""
    return sum(x.numel() * x.element_size() for x in (cnt, pi, out))


def pair_cost_work(cnt):
    """Entropy terms of the pair cost: one for each row with ``cnt > 0``, as a
    0-d float64 tensor on the device."""
    return (cnt > 0).sum().double()


def share(readings, kernel: str, device_name: str):
    """A kernel's share of its roofline over the window, in %: the sum of its
    launches' bounds over the sum of their device times in the trace, the
    launches matched by ``device_name`` in the kernel's name. None when the
    trace holds no such launch, or another number of them than were
    recorded."""
    t = readings.trace
    bounds = readings.bounds.get(kernel, [])
    names = [n for n in (t.device_s if t is not None else {}) if device_name in n]
    if not bounds or not names:
        return None
    launches = sum(t.launches[n] for n in names)
    device_s = sum(t.device_s[n] for n in names)
    if launches != len(bounds) or device_s <= 0.0:
        return None
    return sum(bounds) / device_s * 100.0
