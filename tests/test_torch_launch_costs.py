"""``repro_torch.launch.costs`` (the dry-run's roofline accounting) against
``repro.launch.costs``: MODEL_FLOPS for every architecture × applicable
shape, the roofline dict in the reference's own constants, the counted
FLOPs of one smoke block of each kind against the reference's closed forms,
the counter against ``FlopCounterMode`` and the hand kernels' analytic
costs at their call sites (``kernels/ops.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import costs as rcosts

from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import costs
from repro_torch.launch.lowering import init_params
from repro_torch.models import flash, mamba2, xlstm
from repro_torch.models.api import build_model

CELLS = [(a, s) for a in ARCHS for s in applicable_shapes(get_config(a))]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    assert costs.model_flops(get_config(arch), SHAPES[shape]) == rcosts.model_flops(
        ref_get_config(arch), REF_SHAPES[shape])


def _reference_hardware(n_chips: int) -> costs.Hardware:
    """The reference's constants as a card: its bfloat16 peak, its HBM rate
    and one link rate for every group (a node as large as the mesh)."""
    return costs.Hardware(name="reference constants", bf16_flops=rcosts.PEAK_FLOPS,
                          fp32_flops=rcosts.PEAK_FLOPS, fp64_flops=rcosts.PEAK_FLOPS,
                          hbm_bytes_per_s=rcosts.HBM_BW, nvlink_bytes_per_s=rcosts.ICI_BW,
                          node_size=n_chips, internode_bytes_per_s=rcosts.ICI_BW, num_sms=1,
                          sfu_per_sm_per_clk=1)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_equals_the_reference_in_its_constants(arch, shape, monkeypatch):
    """Counted inputs through both rooflines. The port has no scan
    correction (its traced loops run every trip), so the reference's are
    set to 0 here; a decode shape has none to begin with."""
    sp = SHAPES[shape]
    if sp.kind != "decode":
        monkeypatch.setattr(rcosts, "flop_correction", lambda *a, **k: 0.0)
        monkeypatch.setattr(rcosts, "bytes_correction", lambda *a, **k: 0.0)
    kw = dict(hlo_flops_per_dev=3.25e13, hlo_bytes_per_dev=7.5e11, coll_bytes_per_dev=2.0e10,
              n_chips=256, remat=True)
    want = rcosts.roofline(cfg=ref_get_config(arch), sp=REF_SHAPES[shape], **kw)
    got = costs.roofline(cfg=get_config(arch), sp=sp, hardware=_reference_hardware(256), **kw)
    assert got == want


def test_links_are_priced_at_the_slowest_one_crossed():
    h = costs.H100
    assert h.link_bytes_per_s(range(8)) == 450e9
    assert h.link_bytes_per_s(range(8, 16)) == 450e9
    assert h.link_bytes_per_s(range(4, 12)) == 50e9
    assert h.link_bytes_per_s([0, 16, 32]) == 50e9
    assert h.peak_flops("bfloat16") == 989e12 and h.peak_flops("float32") == 67e12


def _count(fn, *args) -> float:
    c = costs.WorkCounter("meta")
    with c:
        fn(*args)
    return c.flops


def test_one_attention_counts_the_closed_form():
    """Blockwise attention at 8 × 2 blocks (the KV loop folded on meta):
    QKᵀ and PV over every block, ``4·b·h·s·t·hd``, the reference's
    ``_attn_instance``."""
    b, s, h, k, hd = 2, 2048, 4, 2, 16
    q = torch.empty(b, s, h, hd, device="meta")
    kv = torch.empty(b, s, k, hd, device="meta")
    got = _count(flash.blockwise_attention, q, kv, kv)
    assert got == costs.attn_flops(b, s, s, h, hd) == rcosts._attn_instance(b, s, s, h, hd, 1.0)[0]


def _smoke_block(arch: str, key: str):
    cfg = get_smoke_config(arch)
    return cfg, init_params(build_model(cfg, "meta"))[key]


def test_one_ssd_counts_the_closed_form_less_its_elementwise_term():
    """The SSD chunk loop of a smoke Mamba2 block: the reference's
    ``_ssd_instance`` less its ``2·b·s·q·h`` term, the decay weighting of
    the ``[q, q]`` scores, which is elementwise (``FlopCounterMode`` counts
    products only)."""
    cfg, blk = _smoke_block("zamba2_7b", "ssm_0")
    _, di, h, _, n = mamba2.dims(cfg)
    b, s = 2, 64
    u = torch.empty(b, s, cfg.d_model, device="meta")
    loop = _count(mamba2.ssd_heads, blk, u, cfg) - 2.0 * b * s * cfg.d_model * (2 * di + 2 * n + h)
    q = min(cfg.ssm_chunk, s)
    want = rcosts._ssd_instance(ref_get_smoke_config("zamba2_7b"), b, s, 1.0)[0]
    assert want == costs.ssd_flops(cfg, b, s)
    assert loop == want - 2.0 * b * s * q * h


def test_one_mlstm_counts_its_loop_against_the_closed_form():
    """The mLSTM chunk loop at two chunks: three ``q·h·p`` products a
    position, as the reference's ``_mlstm_instance``, but two ``h·p·p``
    ones (the carried C read and its update) where the closed form charges
    three, and two ``h·p`` ones (n's read and update) it leaves out:
    counted / closed form = (3qhp + 2hpp + 2hp) / (3qhp + 3hpp) = 0.93541666…
    here."""
    cfg, blk = _smoke_block("xlstm_350m", "layer_0")
    _, di, h, p = xlstm.mlstm_dims(cfg)
    b, s, q = 2, 512, 256
    u = torch.empty(b, s, di, device="meta")
    proj = costs.WorkCounter("meta")
    with proj:
        xlstm._mlstm_qkvg(blk, u, cfg)
    loop = _count(xlstm.mlstm_cell, blk, u, cfg) - proj.flops
    closed = rcosts._mlstm_instance(ref_get_smoke_config("xlstm_350m"), b, s, 1.0)[0]
    assert closed == costs.mlstm_flops(cfg, b, s)
    assert loop == 2.0 * b * s * (3 * q * h * p + 2 * h * p * p + 2 * h * p)
    assert loop / closed == pytest.approx(0.9354166666666667, rel=1e-15)


def test_one_slstm_counts_the_closed_form():
    """The sLSTM step loop: four recurrent ``dh × dh`` products a step and
    head, the reference's ``_slstm_instance``."""
    cfg, blk = _smoke_block("xlstm_350m", "layer_1")
    b, s = 2, 64
    dh = cfg.d_model // cfg.n_heads
    gin = torch.empty(b, s, 4, cfg.n_heads, dh, device="meta")
    got = _count(xlstm.slstm_scan, blk["r"], gin)
    closed = rcosts._slstm_instance(ref_get_smoke_config("xlstm_350m"), b, s, 1.0)[0]
    assert got == closed == costs.slstm_flops(cfg, b, s)


@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "granite_moe_3b_a800m", "zamba2_7b",
                                  "xlstm_350m", "whisper_large_v3", "paligemma_3b"])
def test_the_counter_gives_flop_counter_modes_flops(arch):
    """A smoke forward and backward on CPU tensors: the counter's FLOPs
    (``flop_registry``'s formulas) equal ``FlopCounterMode``'s, and its
    count on ``meta`` the same."""
    cfg = get_smoke_config(arch)
    b, s = 2, 32
    counts = {}
    for dev in ("cpu", "meta"):
        model = build_model(cfg, dev)
        params = init_params(model)
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=dev)}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((b, cfg.enc_len, cfg.d_model), device=dev)
        if cfg.family == "vlm":
            batch["img_emb"] = torch.zeros((b, cfg.img_tokens, cfg.img_dim), device=dev)
        leaves = [x.requires_grad_() for x in _leaves(params) if x.is_floating_point()]

        def run():
            loss, _ = model.loss(params, batch, remat=False)
            torch.autograd.grad(loss, leaves)

        c = costs.WorkCounter(dev)
        with c:
            run()
        counts[dev] = c.flops
        if dev == "cpu":
            fc = FlopCounterMode(display=False)
            with fc:
                run()
            assert c.flops == fc.get_total_flops() > 0
    assert counts["meta"] == counts["cpu"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_kernel_work_matches_the_bounds_formulas():
    assert costs.merge_gain_flops(3, 32, 128) == 3 * 32 * 32 * (14 * 128 + 10)
    assert costs.merge_gain_bytes(65536, 32, 128) == 65536 * (32 * 128 + 3 * 32 * 32
                                                              + 4 * 32 + 128) * 4
    assert costs.pair_cost_bytes(1000) == 12000
    assert costs.segment_sum_bytes(10, 100, 2) == 8 * 11 + 8 * 100 + 8 * 10 + 8 * 2
    assert costs.ordered_sum_bytes(9, 64) == 8 * 9 * 64 + 8 * 9


def test_a_hand_kernels_call_counts_its_own_work():
    """``ops.merge_gain`` and ``ops.pair_cost`` on CPU tensors under a
    counter: the plain versions run (the same values as without it) and the
    count is the kernels' analytic work, not the plain versions' ops."""
    g, c, u = 3, 8, 16
    rng = np.random.default_rng(0)
    m = torch.as_tensor(rng.poisson(0.5, (g, c, u)).astype(np.float32))
    n = torch.ones(g, c)
    s = torch.zeros(g, c)
    t = torch.full((g, c), 50.0)
    n_u = torch.ones(g, u)
    cidx = torch.arange(c, dtype=torch.int32).repeat(g, 1)
    w = torch.zeros(g, c, c)
    scal = torch.tensor([30.0, 12.0])
    want = ops.merge_gain(m, n, s, t, n_u, cidx, w, scal)
    cnt, pi = m.reshape(-1), torch.full((g * c * u,), 4.0)
    counter = costs.WorkCounter("cpu")
    with counter:
        got = ops.merge_gain(m, n, s, t, n_u, cidx, w, scal)
        cost = ops.pair_cost(cnt, pi, scal)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cost.shape == (g * c * u,)
    assert counter.kernel_calls == {"merge_gain": 1, "pair_cost": 1}
    assert counter.flops == costs.merge_gain_flops(g, c, u)
    assert counter.bytes == costs.merge_gain_bytes(g, c, u) + costs.pair_cost_bytes(g * c * u)
    assert ops.COUNTER is None


def test_the_peak_follows_live_storages():
    c = costs.WorkCounter("meta")
    x = torch.empty(1024, device="meta")  # 4 KiB, an argument
    assert c.add_storages([x]) == 4096
    with c:
        y = x * 2.0  # +4 KiB
        z = y.view(32, 32)  # a view: no storage
        del y
        w = z + 1.0  # +4 KiB: 12 KiB live
        del z, w
        v = x.clone()  # y, z and w gone: 8 KiB live
    assert c.peak == 3 * 4096 and c.live == 2 * 4096
    del v
    assert c.live == 4096
