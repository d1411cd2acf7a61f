"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar
memory, true recurrence), alternating 1:1 (xlstm-350m config).

Port of ``repro/models/xlstm.py``. The mLSTM forward stabilises the
exponential input gate with a *global* max-shift ``m_g = max_t ĩ_t`` taken
outside the chunk loop (a Python loop here, ``lax.scan`` there), and its
denominator threshold is ``exp(-m_g)``; decode carries a running ``m``
instead. The two agree to the reference's own 2e-3, not to the last bit.
The sLSTM is a step loop over a float32 per-head block-diagonal ``R``,
followed by a GeGLU feed-forward (``f = int(8·d/3/64)·64``, the tanh form of
gelu). Both ``m`` states start at -30.0 in :func:`init_xlstm_cache`.
Under a model group both blocks split their heads over the ranks
(:func:`mlstm_forward_tp`, :func:`slstm_forward_tp`); ``mlstm_up``,
``mlstm_cell``, ``mlstm_gate_down``, ``slstm_gates`` and ``slstm_scan`` are
the per-rank code, which ``models/tp_ranks.py`` runs for every rank in one
process. Under a serve table's model group the decode steps step a rank's
heads of a state split on them (:func:`mlstm_decode_tp`,
:func:`slstm_decode_tp`).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import transformer
from repro_torch.models.common import (apply_mlp, apply_norm, dense_init, embed_init, init_norm,
                                       mlp_tp, norm_axes, norm_shapes, norm_tp, normal_init,
                                       remat_call)

M_INIT = -30.0


def _decay(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_dims(cfg):
    d = cfg.d_model
    di = 2 * d  # pf = 2 up-projection
    h = cfg.n_heads
    p = di // h
    return d, di, h, p


def init_mlstm(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d, di, h, p = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": init_norm(d, cfg.norm, device),
        "up_x": dense_init(gen, (d, di), 0, dtype, device),
        "up_z": dense_init(gen, (d, di), 0, dtype, device),
        "wq": dense_init(gen, (di, di), 0, dtype, device),
        "wk": dense_init(gen, (di, di), 0, dtype, device),
        "wv": dense_init(gen, (di, di), 0, dtype, device),
        "w_if": dense_init(gen, (di, 2 * h), 0, torch.float32, device),
        "b_if": torch.cat([torch.zeros(h, **f32), torch.full((h,), 3.0, **f32)]),
        "out_norm": init_norm(di, cfg.norm, device),
        "down": dense_init(gen, (di, d), 0, dtype, device),
    }


def mlstm_shapes(cfg) -> dict:
    d, di, h, _ = mlstm_dims(cfg)
    return {"ln": norm_shapes(d, cfg.norm), "up_x": (d, di), "up_z": (d, di),
            "wq": (di, di), "wk": (di, di), "wv": (di, di), "w_if": (di, 2 * h),
            "b_if": (2 * h,), "out_norm": norm_shapes(di, cfg.norm), "down": (di, d)}


def mlstm_axes(cfg) -> dict:
    norm = norm_axes(cfg.norm)
    return {"ln": norm, "up_x": ("embed", "ff"), "up_z": ("embed", "ff"), "wq": ("ff", None),
            "wk": ("ff", None), "wv": ("ff", None), "w_if": ("ff", None), "b_if": (None,),
            "out_norm": norm, "down": ("ff", "embed")}


def mlstm_reads(cfg, h0: int, h1: int, device) -> dict:
    """What the part of the block that computes heads ``[h0, h1)`` reads
    of each leaf (``TensorParallel.read``'s map). ``di`` is head-major, so
    its columns of ``up_x``/``up_z``, its entries of ``out_norm`` and its
    rows of ``down`` are its part of ``di``; ``wq``/``wk``/``wv`` mix all of
    ``u``, so it reads their columns of its heads (and the gathered ``u``),
    and of ``w_if``/``b_if`` its heads' input and forget gates."""
    _, di, h, hp = mlstm_dims(cfg)
    cols = torch.arange(h0 * hp, h1 * hp, device=device)
    gates = torch.cat([torch.arange(h0, h1, device=device),
                       torch.arange(h + h0, h + h1, device=device)])
    return {"up_x": 1, "up_z": 1, "wq": (1, cols), "wk": (1, cols), "wv": (1, cols),
            "w_if": (1, gates), "b_if": (0, gates), "out_norm": {"scale": 0}, "down": 0}


def _mlstm_qkvg(p, u, cfg):
    """q, k, v and the gates' pre-activations of the heads whose leaves
    ``p`` holds (every head, or a rank's part), from all of ``u``."""
    hp = mlstm_dims(cfg)[3]
    h = p["w_if"].shape[1] // 2
    b, s, _ = u.shape
    q = torch.matmul(u, p["wq"]).reshape(b, s, h, hp)
    k = torch.matmul(u, p["wk"]).reshape(b, s, h, hp) / _key_scale(u, hp)
    v = torch.matmul(u, p["wv"]).reshape(b, s, h, hp)
    gates = torch.matmul(u.float(), p["w_if"]) + p["b_if"]
    i_raw, f_raw = gates[..., :h], gates[..., h:]
    return q.float(), k.float(), v.float(), i_raw, f_raw


def _key_scale(u, hp: int):
    """The keys' divisor: the reference divides by sqrt(hp) rounded to
    float32, then to ``u``'s type."""
    return torch.tensor(float(np.sqrt(np.float32(hp))), dtype=u.dtype, device=u.device)


def mlstm_up(p, xin):
    """The up projections ``(u, z)`` of the normed input (a rank's part of
    ``di`` where ``p`` holds a rank's columns)."""
    return torch.matmul(xin, p["up_x"]), torch.matmul(xin, p["up_z"])


def mlstm_gate_down(p, hout, z):
    """The ``silu(z)`` gate and the down projection of the normed cell
    output (a rank's partial sum where ``p`` holds a rank's rows)."""
    hout = hout * F.silu(z.float()).to(hout.dtype)
    return torch.matmul(hout, p["down"])


def _mlstm_out(p, hout, z, x, cfg):
    """Out-norm, the ``silu(z)`` gate, the down projection and the residual."""
    hout = apply_norm(p["out_norm"], hout.to(x.dtype), cfg.norm, cfg.norm_eps)
    return x + mlstm_gate_down(p, hout, z)


def mlstm_forward(p, x, cfg, *, chunk: int = 256, tp=None):
    """Full-sequence mLSTM. x: [B, S, d] → [B, S, d]; ``chunk`` (at most S)
    must divide S. ``tp``: the model group, over which the heads are split
    (:func:`mlstm_forward_tp`)."""
    if tp is not None:
        return mlstm_forward_tp(p, x, cfg, tp, chunk=chunk)
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    u, z = mlstm_up(p, xin)
    return _mlstm_out(p, mlstm_cell(p, u, cfg, chunk=chunk), z, x, cfg)


def mlstm_forward_tp(p, x, cfg, tp, *, chunk: int = 256):
    """:func:`mlstm_forward` under the model group ``tp``: each rank
    up-projects its heads' part of ``di``, gathers ``u`` (so its q, k and v
    columns are the whole block's dot products over ``di``), runs the chunk
    loop over its heads (the stabiliser ``m_g`` is per head), the RMSNorm
    over its part of ``di`` with the sums of squares added over the group,
    and a row-parallel ``down``; one reduce. Where the group does not split
    the heads, every rank computes the whole block."""
    _, di, h, _ = mlstm_dims(cfg)
    shapes, axes = mlstm_shapes(cfg), mlstm_axes(cfg)
    if not tp.splits(h):
        return mlstm_forward(tp.whole(p, axes, shapes), x, cfg, chunk=chunk)
    local = tp.read(p, axes, shapes, mlstm_reads(cfg, *tp.part(h), x.device))
    u, z = mlstm_up(local, tp.copy(apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)))
    hout = mlstm_cell(local, tp.gather_dim(u, -1, reduce_grad=True), cfg, chunk=chunk)
    hout = norm_tp(local["out_norm"], hout.to(x.dtype), cfg.norm, di, cfg.norm_eps, tp)
    return x + tp.reduce(mlstm_gate_down(local, hout, z))


def mlstm_cell(p, u, cfg, *, chunk: int = 256):
    """The chunkwise mLSTM of the heads whose leaves ``p`` holds, from all
    of ``u`` [B, S, di]: the float32 cell output [B, S, heads·P] before
    the out-norm."""
    hp = mlstm_dims(cfg)[3]
    b, s, _ = u.shape
    q_len = min(chunk, s)
    if s % q_len:
        raise ValueError(f"mlstm_forward: sequence length {s} is not a multiple of the "
                         f"chunk {q_len}")
    nc = s // q_len
    q, k, v, i_raw, f_raw = _mlstm_qkvg(p, u, cfg)
    h = i_raw.shape[-1]

    m_g = torch.amax(i_raw, dim=1, keepdim=True)  # [B,1,H] global stabilizer
    iw = torch.exp(i_raw - m_g)  # [B,S,H]
    logf = F.logsigmoid(f_raw)  # ≤ 0
    lcs_full = torch.cumsum(logf.reshape(b, nc, q_len, h), dim=2)
    ltot = lcs_full[:, :, -1, :]

    qr = q.reshape(b, nc, q_len, h, hp)
    kr = k.reshape(b, nc, q_len, h, hp)
    vr = v.reshape(b, nc, q_len, h, hp)
    ir = iw.reshape(b, nc, q_len, h)
    iota = torch.arange(q_len, device=u.device)
    causal = (iota[:, None] >= iota[None, :]).float()

    cst = torch.zeros((b, h, hp, hp), dtype=torch.float32, device=u.device)
    nst = torch.zeros((b, h, hp), dtype=torch.float32, device=u.device)
    nums, dens = [], []
    for c in range(nc):
        qc, kc, vc, ic, lc, lt = qr[:, c], kr[:, c], vr[:, c], ir[:, c], lcs_full[:, c], ltot[:, c]
        dec = _decay(lc[:, :, None, :] - lc[:, None, :, :])
        wgt = dec * causal[None, :, :, None] * ic[:, None, :, :]  # [B,i,j,H]
        scores = torch.einsum("bihp,bjhp->bijh", qc, kc)
        num_intra = torch.einsum("bijh,bjhp->bihp", scores * wgt, vc)
        den_vec = torch.einsum("bijh,bjhp->bihp", wgt, kc)  # Σ_j dec·i·k_j
        dec_i = _decay(lc)
        num_carry = torch.einsum("bihp,bhpr->bihr", qc, cst) * dec_i[..., None]
        den_carry = torch.einsum("bihp,bhp->bih", qc, nst) * dec_i
        nums.append(num_intra + num_carry)
        dens.append(torch.sum(qc * den_vec, dim=-1) + den_carry)
        dec_j = _decay(lt[:, None, :] - lc) * ic
        cst = _decay(lt)[..., None, None] * cst + torch.einsum(
            "bjh,bjhp,bjhr->bhpr", dec_j, kc, vc)
        nst = _decay(lt)[..., None] * nst + torch.einsum("bjh,bjhp->bhp", dec_j, kc)
    num = torch.stack(nums, dim=1).reshape(b, s, h, hp)
    den = torch.stack(dens, dim=1).reshape(b, s, h)
    thr = torch.exp(-m_g)  # [B,1,H]
    hout = num / torch.maximum(torch.abs(den), thr)[..., None]
    return hout.reshape(b, s, h * hp)


def mlstm_decode(p, x, cfg, state, tp=None):
    """state = {"c": [B,H,P,P], "n": [B,H,P], "m": [B,H]} (true m-state).
    ``tp``: a serve table's model group (:func:`mlstm_decode_tp`)."""
    if tp is not None:
        return mlstm_decode_tp(p, x, cfg, state, tp)
    b = x.shape[0]
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    u, z = mlstm_up(p, xin)
    q, k, v, i_raw, f_raw = _mlstm_qkvg(p, u, cfg)
    hout, new = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0], f_raw[:, 0], state)
    return _mlstm_out(p, hout.reshape(b, 1, -1), z, x, cfg), new


def _mlstm_step(q, k, v, i_raw, f_raw, state):
    """One token's mLSTM update of the heads of ``q``, ``k``, ``v``
    [B, H, P] and the gates' pre-activations [B, H], float32: the cell
    output [B, H, P] before the out-norm, and the new state."""
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + state["m"], i_raw)
    fw = _decay(logf + state["m"] - m_new)
    iw = _decay(i_raw - m_new)
    c_new = fw[..., None, None] * state["c"] + iw[..., None, None] * torch.einsum(
        "bhp,bhr->bhpr", k, v)
    n_new = fw[..., None] * state["n"] + iw[..., None] * k
    num = torch.einsum("bhp,bhpr->bhr", q, c_new)
    den = torch.einsum("bhp,bhp->bh", q, n_new)
    hout = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return hout, {"c": c_new, "n": n_new, "m": m_new}


def mlstm_decode_tp(p, x, cfg, state, tp):
    """:func:`mlstm_decode` on rank ``tp.rank`` of a serve table's model
    group, ``p`` its stored leaves and ``state`` its shard. The table
    stores ``up_x``/``up_z`` by their ``di`` columns and ``wq``, ``wk``,
    ``wv`` and ``w_if`` by their ``di`` rows, the same blocks: a rank's
    columns of ``u`` are the rows it holds. So each rank's partial products
    of q, k, v and the gates are added over the group in rank order:
    reduce-scattered to the rank's heads where the table splits the heads
    (the state is then the rank's heads'), else summed on every rank (q, k
    and v as a reduce-scatter over ``di`` and a gather), and every rank
    steps every head. Then the out-norm over ``di`` (the sums of squares
    added over the group where the heads are split), the ``silu(z)`` gate on
    the rank's part of ``di``, a row-parallel ``down`` and one sum. No
    ``di × di`` leaf is gathered; where the table keeps ``di`` whole, every
    rank computes the whole block."""
    _, di, h, hp = mlstm_dims(cfg)
    shapes, axes = mlstm_shapes(cfg), mlstm_axes(cfg)
    if tp.rules.split_dim(axes["wq"], shapes["wq"], "model") != 0:
        return mlstm_decode(tp.whole(p, axes, shapes), x, cfg, state)
    b = x.shape[0]
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    u, z = mlstm_up(p, xin)  # this rank's part of di
    qkv = torch.stack([torch.matmul(u[:, 0], p[w]) for w in ("wq", "wk", "wv")], 1)  # [B,3,di]
    gates = torch.matmul(u[:, 0].float(), p["w_if"]).unflatten(-1, (2, h))  # [B,2,H]
    b_if = p["b_if"].unflatten(-1, (2, h))
    heads = tp.splits(h)
    if heads:
        h0, h1 = tp.part(h)
        qkv, gates, b_if = tp.reduce_scatter(qkv, -1), tp.reduce_scatter(gates, -1), b_if[:, h0:h1]
    else:  # every head on every rank: q, k and v reduce-scattered over di, then gathered
        qkv, gates = tp.gather_dim(tp.reduce_scatter(qkv, -1), -1), tp.sum(gates)
    gates = gates + b_if
    nh = gates.shape[-1]
    q, k, v = (t.reshape(b, nh, hp) for t in qkv.unbind(1))
    k = k / _key_scale(u, hp)
    hout, new = _mlstm_step(q.float(), k.float(), v.float(), gates[:, 0], gates[:, 1], state)
    hout = hout.reshape(b, 1, -1).to(x.dtype)
    d0, d1 = tp.part(di)
    if heads:
        hout = norm_tp({"scale": p["out_norm"]["scale"][d0:d1]}, hout, cfg.norm, di,
                       cfg.norm_eps, tp)
    else:
        hout = apply_norm(p["out_norm"], hout, cfg.norm, cfg.norm_eps)[..., d0:d1]
    return x + tp.sum(mlstm_gate_down(p, hout, z)), new


def init_mlstm_state(cfg, batch: int, device="cuda"):
    d, di, h, hp = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, h, hp, hp), **f32), "n": torch.zeros((batch, h, hp), **f32),
            "m": torch.full((batch, h), M_INIT, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_dims(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    return d, h, d // h


def _ffn_width(d: int) -> int:
    return int(8 * d / 3 / 64) * 64  # GeGLU pf 4/3 ×2 (xLSTM paper)


def init_slstm(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d, h, dh = slstm_dims(cfg)
    f = _ffn_width(d)
    return {
        "ln": init_norm(d, cfg.norm, device),
        "w_in": dense_init(gen, (d, 4, h, dh), 0, dtype, device),
        "r": normal_init(gen, (4, h, dh, dh), 1.0 / math.sqrt(dh), torch.float32, device),
        "b": torch.zeros((4, h, dh), dtype=torch.float32, device=device),
        "out_norm": init_norm(d, cfg.norm, device),
        "ln_ffn": init_norm(d, cfg.norm, device),
        "ffn_wi": dense_init(gen, (d, f), 0, dtype, device),
        "ffn_wg": dense_init(gen, (d, f), 0, dtype, device),
        "ffn_wo": dense_init(gen, (f, d), 0, dtype, device),
    }


def slstm_shapes(cfg) -> dict:
    d, h, dh = slstm_dims(cfg)
    f = _ffn_width(d)
    norm = norm_shapes(d, cfg.norm)
    return {"ln": norm, "w_in": (d, 4, h, dh), "r": (4, h, dh, dh), "b": (4, h, dh),
            "out_norm": norm, "ln_ffn": norm, "ffn_wi": (d, f), "ffn_wg": (d, f),
            "ffn_wo": (f, d)}


def slstm_axes(cfg) -> dict:
    norm = norm_axes(cfg.norm)
    return {"ln": norm, "w_in": ("embed", None, "heads", None), "r": (None, "heads", None, None),
            "b": (None, "heads", None), "out_norm": norm, "ln_ffn": norm,
            "ffn_wi": ("embed", "ff"), "ffn_wg": ("embed", "ff"), "ffn_wo": ("ff", "embed")}


def _slstm_cell(r, gin, st):
    """One step. gin: [B,4,H,dh] pre-activations; st = (c, n, hprev, m)."""
    c, n, hprev, m = st
    rec = torch.einsum("bhx,ghxy->bghy", hprev, r)  # [B,4,H,dh]
    za, ia, fa, oa = [gin[:, g] + rec[:, g] for g in range(4)]
    z = torch.tanh(za)
    o = torch.sigmoid(oa)
    m_new = torch.maximum(fa + m, ia)
    i = _decay(ia - m_new)
    f = _decay(fa + m - m_new)
    c_new = f * c + i * z
    n_new = f * n + i
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new)


#: what the part of the sLSTM block that computes a rank's heads reads of
#: the recurrence's leaves (``TensorParallel.read``'s map): its heads of
#: ``w_in``, ``r`` and ``b`` (per head, block-diagonal) and its entries of
#: ``out_norm`` (``d`` is head-major). The GeGLU FFN splits on ``ff``.
SLSTM_READS = {"w_in": 2, "r": 1, "b": 1, "out_norm": {"scale": 0}}


def ffn_leaves(p) -> dict:
    """The GeGLU FFN's leaves under ``models/common.py``'s MLP keys."""
    return {"wi": p["ffn_wi"], "wg": p["ffn_wg"], "wo": p["ffn_wo"]}


def slstm_gates(p, xin):
    """The four gates' input pre-activations of the heads whose leaves
    ``p`` holds, from the normed input, float32: [B, S, 4, H, dh]."""
    d, _, h, dh = p["w_in"].shape
    gin = torch.matmul(xin, p["w_in"].reshape(d, -1)).unflatten(-1, (4, h, dh))
    return gin.float() + p["b"][None, None]


def slstm_scan(r, gin):
    """The step loop over ``gin`` [B, S, 4, H, dh] with the heads' ``r``:
    every step's ``h``, [B, S, H·dh] float32."""
    b, s, _, h, dh = gin.shape
    z0 = torch.zeros((b, h, dh), dtype=torch.float32, device=gin.device)
    st = (z0, z0, z0, torch.full((b, h, dh), M_INIT, dtype=torch.float32, device=gin.device))
    hs = []
    for t in range(s):
        st = _slstm_cell(r, gin[:, t], st)
        hs.append(st[2])
    return torch.stack(hs, dim=1).reshape(b, s, h * dh)


def _slstm_out(p, hout, x, cfg, tp=None):
    """Out-norm and residual, then the post-block GeGLU FFN (pf 4/3 ×2),
    split over ``ff`` under a model group ``tp``."""
    hout = apply_norm(p["out_norm"], hout.to(x.dtype), cfg.norm, cfg.norm_eps)
    return _slstm_ffn(p, x + hout, cfg, tp)


def _slstm_ffn(p, x, cfg, tp=None):
    hf = apply_norm(p["ln_ffn"], x, cfg.norm, cfg.norm_eps)
    if tp is None:
        return x + apply_mlp(ffn_leaves(p), hf, "gelu")
    mlp = functools.partial(apply_mlp, act="gelu")
    return x + mlp_tp(ffn_leaves(p), hf, tp, _ffn_width(cfg.d_model), mlp)


def slstm_forward(p, x, cfg, *, tp=None):
    """``tp``: the model group, over which the heads are split
    (:func:`slstm_forward_tp`)."""
    if tp is not None:
        return slstm_forward_tp(p, x, cfg, tp)
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    return _slstm_out(p, slstm_scan(p["r"], slstm_gates(p, xin)), x, cfg)


def slstm_forward_tp(p, x, cfg, tp):
    """:func:`slstm_forward` under the model group ``tp``: each rank's step
    loop over its heads (``w_in``, ``r`` and ``b`` are per head: no
    collective in the loop), the RMSNorm over its part of ``d`` with the
    sums of squares added over the group, the parts gathered for the
    residual, then the GeGLU FFN column- and row-parallel over ``ff``.
    Where the group does not split the heads, every rank runs the whole
    recurrence (the FFN splits where ``ff`` does)."""
    d, h, _ = slstm_dims(cfg)
    shapes, axes = slstm_shapes(cfg), slstm_axes(cfg)
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    if not tp.splits(h):
        rec = tp.whole({k: p[k] for k in SLSTM_READS}, axes, shapes)
        return _slstm_out(dict(p, **rec), slstm_scan(rec["r"], slstm_gates(rec, xin)), x, cfg,
                          tp)
    local = tp.read(p, axes, shapes, SLSTM_READS)
    hout = slstm_scan(local["r"], slstm_gates(local, tp.copy(xin)))
    hout = norm_tp(local["out_norm"], hout.to(x.dtype), cfg.norm, d, cfg.norm_eps, tp)
    return _slstm_ffn(p, x + tp.gather_dim(hout, -1), cfg, tp)


def slstm_decode(p, x, cfg, state, tp=None):
    """``tp``: a serve table's model group (:func:`slstm_decode_tp`)."""
    if tp is not None:
        return slstm_decode_tp(p, x, cfg, state, tp)
    d, h, dh = slstm_dims(cfg)
    b = x.shape[0]
    gin = slstm_gates(p, apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps))[:, 0]
    c, n, hh, m = _slstm_cell(p["r"], gin, (state["c"], state["n"], state["h"], state["m"]))
    return _slstm_out(p, hh.reshape(b, 1, d), x, cfg), {"c": c, "n": n, "h": hh, "m": m}


def slstm_decode_tp(p, x, cfg, state, tp):
    """:func:`slstm_decode` on rank ``tp.rank`` of a serve table's model
    group, ``p`` its stored leaves and ``state`` its shard: ``w_in``, ``r``,
    ``b`` and the state are per head, so each rank steps its heads with no
    collective, the RMSNorm over its part of ``d`` takes the sums of squares
    added over the group, the normed parts are gathered for the residual,
    and the GeGLU FFN runs over ``ff``. Where the table does not split the
    heads, every rank steps every head (the FFN splits where ``ff`` does)."""
    d, h, _ = slstm_dims(cfg)
    b = x.shape[0]
    xin = apply_norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    st = (state["c"], state["n"], state["h"], state["m"])
    if not tp.splits(h):
        rec = tp.whole({k: p[k] for k in SLSTM_READS}, slstm_axes(cfg), slstm_shapes(cfg))
        c, n, hh, m = _slstm_cell(rec["r"], slstm_gates(rec, xin)[:, 0], st)
        out = _slstm_out(dict(p, **rec), hh.reshape(b, 1, d), x, cfg, tp)
        return out, {"c": c, "n": n, "h": hh, "m": m}
    local = tp.read(p, slstm_axes(cfg), slstm_shapes(cfg), SLSTM_READS)
    c, n, hh, m = _slstm_cell(local["r"], slstm_gates(local, xin)[:, 0], st)
    hout = norm_tp(local["out_norm"], hh.reshape(b, 1, -1).to(x.dtype), cfg.norm, d,
                   cfg.norm_eps, tp)
    out = _slstm_ffn(p, x + tp.gather_dim(hout, -1), cfg, tp)
    return out, {"c": c, "n": n, "h": hh, "m": m}


def init_slstm_state(cfg, batch: int, device="cuda"):
    d, h, dh = slstm_dims(cfg)
    shape, f32 = (batch, h, dh), dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **f32), "n": torch.zeros(shape, **f32),
            "h": torch.zeros(shape, **f32), "m": torch.full(shape, M_INIT, **f32)}


# ---------------------------------------------------------------------------
# xLSTM language model: alternating mLSTM (even) / sLSTM (odd) blocks
# ---------------------------------------------------------------------------


def is_mlstm(i: int) -> bool:
    return i % 2 == 0


def init_xlstm_lm(gen, cfg, dtype=torch.bfloat16, device="cuda", place=None):
    """The parameter tree, drawn in the reference's order; ``place(key,
    subtree)`` as in ``transformer.init_lm``."""
    place = place or (lambda key, tree: tree)
    p = {
        "embed": place("embed", embed_init(gen, (cfg.vocab, cfg.d_model), dtype, device)),
        "ln_f": place("ln_f", init_norm(cfg.d_model, cfg.norm, device)),
    }
    for i in range(cfg.n_layers):
        init = init_mlstm if is_mlstm(i) else init_slstm
        p[f"layer_{i}"] = place(f"layer_{i}", init(gen, cfg, dtype, device))
    return p


def param_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_xlstm_lm` makes."""
    out = {"embed": (cfg.vocab, cfg.d_model), "ln_f": norm_shapes(cfg.d_model, cfg.norm)}
    out.update({f"layer_{i}": mlstm_shapes(cfg) if is_mlstm(i) else slstm_shapes(cfg)
                for i in range(cfg.n_layers)})
    return out


def param_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_xlstm_lm` makes."""
    out = {"embed": ("vocab", "embed"), "ln_f": norm_axes(cfg.norm)}
    out.update({f"layer_{i}": mlstm_axes(cfg) if is_mlstm(i) else slstm_axes(cfg)
                for i in range(cfg.n_layers)})
    return out


def _logits(params, h, cfg, tp=None):
    h = apply_norm(params["ln_f"], h, cfg.norm, cfg.norm_eps)
    return transformer.unembed(params, h, cfg, tp)


def xlstm_forward(params, tokens, cfg, *, last_only: bool = False, remat: bool = False,
                  tp=None):
    """``remat``: each block under ``torch.utils.checkpoint``. ``tp``: the
    model group (``params`` then this rank's view of the stored leaves):
    the embedding and the tied head vocab-parallel (the logits this rank's
    vocab part), the mLSTM and sLSTM blocks head-parallel."""
    h = transformer.embed_tokens(params, tokens, cfg, tp)
    for i in range(cfg.n_layers):
        fn = functools.partial(mlstm_forward if is_mlstm(i) else slstm_forward, cfg=cfg, tp=tp)
        h = remat_call(fn, remat, params[f"layer_{i}"], h)
    if last_only:
        h = h[:, -1:]
    return _logits(params, h, cfg, tp), {}


def xlstm_decode_step(params, token, cache, pos, cfg, tp=None, kv_len=None):
    """One-token decode. ``tp``: a serve table's model group (``params``
    this rank's stored leaves, ``cache`` its shard): the embedding and the
    tied head vocab-parallel, the mLSTM and sLSTM steps over their heads
    (:func:`mlstm_decode_tp`, :func:`slstm_decode_tp`); every rank returns
    the whole logits. The state is position-free, so ``pos`` and
    ``kv_len`` are unused."""
    del pos, kv_len
    h = transformer.embed_tokens(params, token[:, None], cfg, tp)
    new_cache = {}
    for i in range(cfg.n_layers):
        fn = mlstm_decode if is_mlstm(i) else slstm_decode
        h, new_cache[f"layer_{i}"] = fn(params[f"layer_{i}"], h, cfg, cache[f"layer_{i}"], tp)
    return transformer.whole_logits(_logits(params, h, cfg, tp)[:, 0], cfg, tp), new_cache


def xlstm_cache_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_xlstm_cache` makes."""
    mlstm = {"c": ("batch", "heads", None, None), "n": ("batch", "heads", None),
             "m": ("batch", "heads")}
    slstm = {k: ("batch", "heads", None) for k in ("c", "n", "h", "m")}
    return {f"layer_{i}": dict(mlstm if is_mlstm(i) else slstm) for i in range(cfg.n_layers)}


def init_xlstm_cache(cfg, batch: int, seq_len: int, device="cuda"):
    del seq_len  # constant-size recurrent state
    return {f"layer_{i}": (init_mlstm_state if is_mlstm(i) else init_slstm_state)(
        cfg, batch, device) for i in range(cfg.n_layers)}

