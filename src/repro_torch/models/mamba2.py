"""Mamba2 (SSD — state-space duality) blocks for zamba2.

Port of ``repro/models/mamba2.py``. The full-sequence path is chunked: a
Python loop over chunks (the reference's ``lax.scan``) carries the
inter-chunk state [B, H, N, P]; within a chunk the quadratic
"attention-like" form is a few batched einsums over one [B, Q, Q, H] tile
(Q = ``cfg.ssm_chunk``). The decode path advances the state one token.

Types follow the reference op for op: x, dt, B and C go to float32 for the
scan, ``y`` returns to the model type before the ``silu(z)`` gate; the
depthwise conv runs in the model type and its ``silu`` in float32, cast
back. Decode keeps the conv state in the model type and ``h`` in float32.
Every decay is ``exp(clip(·, -60, 0))``. One B/C group is shared by all
heads. Under a model group the heads are split over the ranks
(:func:`ssd_forward_tp`): :func:`ssd_heads` is the per-rank code, which
``models/tp_ranks.py`` runs for every rank in one process. Under a serve
table's model group the decode step keeps the state whole on every rank
and splits the products (:func:`ssd_decode_tp`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import (apply_norm, dense_init, init_norm, matmul_cols, matmul_rows,
                                       norm_axes, norm_shapes, norm_tp, normal_init)

CONV_W = 4


def dims(cfg, d_model=None):
    d = d_model or cfg.d_model
    di = cfg.ssm_expand * d
    p = cfg.ssm_head_dim
    h = di // p
    n = cfg.ssm_state
    return d, di, h, p, n


def init_mamba2(gen, cfg, dtype=torch.bfloat16, device="cuda"):
    d, di, h, p, n = dims(cfg)
    conv_ch = di + 2 * n  # conv over (x, B, C) as in mamba2
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": init_norm(d, cfg.norm, device),
        "in_proj": dense_init(gen, (d, 2 * di + 2 * n + h), 0, dtype, device),
        "conv_w": normal_init(gen, (CONV_W, conv_ch), 0.1, dtype, device),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros(h, **f32),
        "d_skip": torch.ones(h, **f32),
        "out_norm": init_norm(di, cfg.norm, device),
        "out_proj": dense_init(gen, (di, d), 0, dtype, device),
    }


def param_shapes(cfg) -> dict:
    """The shape of every leaf :func:`init_mamba2` makes."""
    d, di, h, _, n = dims(cfg)
    return {"ln": norm_shapes(d, cfg.norm), "in_proj": (d, 2 * di + 2 * n + h),
            "conv_w": (CONV_W, di + 2 * n), "conv_b": (di + 2 * n,), "a_log": (h,),
            "dt_bias": (h,), "d_skip": (h,), "out_norm": norm_shapes(di, cfg.norm),
            "out_proj": (di, d)}


def param_axes(cfg) -> dict:
    """The logical axes of every leaf :func:`init_mamba2` makes."""
    return {"ln": norm_axes(cfg.norm), "in_proj": ("embed", "ff"), "conv_w": (None, "ff"),
            "conv_b": ("ff",), "a_log": (None,), "dt_bias": (None,), "d_skip": (None,),
            "out_norm": norm_axes(cfg.norm), "out_proj": ("ff", "embed")}


def _split(cfg, u):
    """in_proj output → (z, x, B, C, dt_raw)."""
    _, di, h, _, n = dims(cfg)
    return torch.split(u, [di, di, n, n, h], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv over [B, S, C] with kernel [W, C]."""
    s = x.shape[1]
    pad = F.pad(x, (0, 0, CONV_W - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(CONV_W))
    return F.silu((out + b).float()).to(x.dtype)


def _decay(x):
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_forward(p, x_in, cfg, *, chunk=None, tp=None):
    """Full-sequence SSD. x_in: [B, S, d] → [B, S, d]. ``chunk`` (default
    ``cfg.ssm_chunk``, at most S) must divide S: the reference pads nothing.
    ``tp``: the model group, over which the Mamba heads are split
    (:func:`ssd_forward_tp`)."""
    if tp is not None:
        return ssd_forward_tp(p, x_in, cfg, tp, chunk=chunk)
    u = apply_norm(p["ln"], x_in, cfg.norm, cfg.norm_eps)
    y = ssd_heads(p, u, cfg, chunk=chunk)
    y = apply_norm(p["out_norm"], y, cfg.norm, cfg.norm_eps)
    return x_in + torch.matmul(y, p["out_proj"])


def head_reads(cfg, h0: int, h1: int, device) -> dict:
    """What the part of the block that computes Mamba heads ``[h0, h1)``
    reads of each leaf (``TensorParallel.read``'s map): its ``z``, ``x`` and
    ``dt`` columns of ``in_proj`` and all of ``B`` and ``C`` (one group,
    shared by every head), its ``x`` channels of the conv and all of its
    ``B``/``C`` channels, its entries of ``a_log``, ``dt_bias``, ``d_skip``
    and ``out_norm``, and its rows of ``out_proj``. Head-major ``di``, so a
    rank's heads are its part of every ``h``- and ``di``-long dimension."""
    _, di, _, hp, n = dims(cfg)
    z = torch.arange(h0 * hp, h1 * hp, device=device)
    bc = torch.arange(2 * n, device=device)
    cols = torch.cat([z, di + z, 2 * di + bc,
                      torch.arange(2 * di + 2 * n + h0, 2 * di + 2 * n + h1, device=device)])
    chans = torch.cat([z, di + bc])
    return {"in_proj": (1, cols), "conv_w": (1, chans), "conv_b": (0, chans), "a_log": 0,
            "dt_bias": 0, "d_skip": 0, "out_norm": {"scale": 0}, "out_proj": 0}


def ssd_forward_tp(p, x_in, cfg, tp, *, chunk=None):
    """:func:`ssd_forward` under the model group ``tp``: each rank runs the
    chunk loop over its Mamba heads (:func:`head_reads`; ``B`` and ``C`` on
    every rank, their gradients summed), the RMSNorm over its part of
    ``di`` with the sums of squares added over the group, a row-parallel
    ``out_proj`` and one reduce. Where the group does not split the heads,
    every rank computes the whole block."""
    _, di, h, _, _ = dims(cfg)
    shapes, axes = param_shapes(cfg), param_axes(cfg)
    if not tp.splits(h):
        return ssd_forward(tp.whole(p, axes, shapes), x_in, cfg, chunk=chunk)
    local = tp.read(p, axes, shapes, head_reads(cfg, *tp.part(h), x_in.device))
    u = tp.copy(apply_norm(p["ln"], x_in, cfg.norm, cfg.norm_eps))
    y = ssd_heads(local, u, cfg, chunk=chunk)
    y = norm_tp(local["out_norm"], y, cfg.norm, di, cfg.norm_eps, tp)
    return x_in + tp.reduce(torch.matmul(y, local["out_proj"]))


def ssd_heads(p, u, cfg, *, chunk=None):
    """The SSD of the heads whose leaves ``p`` holds (every head, or a model
    rank's part read by :func:`head_reads`), from ``u``, the normed block
    input [B, S, d]: the ``silu(z)``-gated output [B, S, heads·P] before
    ``out_norm``. ``chunk`` as in :func:`ssd_forward`."""
    _, _, _, hp, n = dims(cfg)
    h = p["a_log"].shape[0]
    di = h * hp
    b, s, _ = u.shape
    q = min(chunk or cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"ssd_forward: sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    nc = s // q

    proj = torch.matmul(u, p["in_proj"])
    z, xc, b_, c_, dt_raw = torch.split(proj, [di, di, n, n, h], dim=-1)
    xbc = _causal_conv(torch.cat([xc, b_, c_], -1), p["conv_w"], p["conv_b"])
    xc, b_, c_ = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,S,H]
    a = -torch.exp(p["a_log"])  # [H]
    loga = dt * a[None, None, :]  # [B,S,H]  (≤ 0)
    xh = xc.reshape(b, s, h, hp).float()
    xdt = xh * dt[..., None]  # discretized input
    bf = b_.float()  # [B,S,N] (ngroups=1, shared across heads)
    cf = c_.float()

    # chunked layout
    lcs = torch.cumsum(loga.reshape(b, nc, q, h), dim=2)  # within-chunk cumulative log decay
    ltot = lcs[:, :, -1, :]  # [B,nc,H]
    xq = xdt.reshape(b, nc, q, h, hp)
    bq = bf.reshape(b, nc, q, n)
    cq = cf.reshape(b, nc, q, n)
    iota = torch.arange(q, device=u.device)
    causal = (iota[:, None] >= iota[None, :]).float()

    hstate = torch.zeros((b, h, n, hp), dtype=torch.float32, device=u.device)
    ys = []
    for c in range(nc):
        xck, bck, cck, lck, ltotk = xq[:, c], bq[:, c], cq[:, c], lcs[:, c], ltot[:, c]
        # intra-chunk quadratic form
        cb = torch.einsum("bin,bjn->bij", cck, bck)  # [B,q,q]
        dec = _decay(lck[:, :, None, :] - lck[:, None, :, :])  # [B,q,q,H]
        w = cb[..., None] * dec * causal[None, :, :, None]  # [B,q,q,H]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xck)
        # contribution of the carried inter-chunk state
        dec_i = _decay(lck)  # [B,q,H]
        y_carry = torch.einsum("bin,bhnp->bihp", cck, hstate) * dec_i[..., None]
        # new chunk state
        dec_j = _decay(ltotk[:, None, :] - lck)  # [B,q,H]
        s_c = torch.einsum("bjn,bjh,bjhp->bhnp", bck, dec_j, xck)
        hstate = _decay(ltotk)[..., None, None] * hstate + s_c
        ys.append(y_intra + y_carry)
    y = torch.stack(ys, dim=1).reshape(b, s, h, hp)
    y = y + xh * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, di).to(u.dtype)
    return y * F.silu(z.float()).to(y.dtype)


def ssd_decode(p, x_in, cfg, state, tp=None):
    """One-token decode. state = {"h": [B,H,N,P] f32, "conv": [B,W-1,C]};
    returns (out, a new state). ``tp``: a serve table's model group
    (:func:`ssd_decode_tp`)."""
    if tp is not None:
        return ssd_decode_tp(p, x_in, cfg, state, tp)
    u = apply_norm(p["ln"], x_in, cfg.norm, cfg.norm_eps)
    y, new = _ssd_step(p, torch.matmul(u, p["in_proj"]), cfg, state,
                       lambda buf: _conv_last(buf, p["conv_w"], p["conv_b"]))
    y = apply_norm(p["out_norm"], y, cfg.norm, cfg.norm_eps)
    return x_in + torch.matmul(y, p["out_proj"]), new


def _conv_last(buf, w, b):
    """The depthwise conv's output at the last position of a window
    ``buf`` [B, W, C] (before its ``silu``): [B, C]."""
    return torch.einsum("bwc,wc->bc", buf, w) + b


def _ssd_step(p, proj, cfg, state, conv):
    """The one-token SSM update of every head from ``proj``, the new
    token's ``in_proj`` output [B, 1, 2·di + 2·n + h] (every column);
    ``conv(window)`` gives the conv's output of every channel. Returns the
    ``silu(z)``-gated ``y`` [B, 1, di] before ``out_norm``, and the new state."""
    _, di, h, hp, n = dims(cfg)
    b = proj.shape[0]
    z, xc, b_, c_, dt_raw = _split(cfg, proj)
    conv_buf = torch.cat([state["conv"], torch.cat([xc, b_, c_], -1)], dim=1)  # [B,W,C]
    xbc = F.silu(conv(conv_buf).float()).to(proj.dtype)[:, None, :]
    xc, b_, c_ = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # [B,H]
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a[None, :])  # [B,H]
    xh = xc[:, 0].reshape(b, h, hp).float()
    bf = b_[:, 0].float()  # [B,N]
    cf = c_[:, 0].float()
    hs = state["h"] * da[..., None, None] + torch.einsum("bn,bh,bhp->bhnp", bf, dt, xh)
    y = torch.einsum("bn,bhnp->bhp", cf, hs) + xh * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, di).to(proj.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    return y, {"h": hs, "conv": conv_buf[:, 1:, :]}


def ssd_decode_tp(p, x_in, cfg, state, tp):
    """:func:`ssd_decode` on rank ``tp.rank`` of a serve table's model
    group, ``p`` its stored leaves. The table keeps the state whole on
    every model rank (``SSM_STATE_AXES``) and splits ``in_proj``, ``conv_w``
    and ``conv_b`` on ``ff``, a contiguous block of the ``[z | x | B | C |
    dt]`` columns that is not a rank's heads. So each rank multiplies by
    its columns of ``in_proj`` and the parts are gathered (``B·(2·di + 2·n
    + h)`` elements), takes its channels of the conv and gathers them
    (``B·(di + 2·n)``), and then runs the SSM update of every head: one
    token's update is cheap, and the state stays the same on every rank
    without moving. ``out_norm`` whole, a row-parallel ``out_proj`` and one
    sum in rank order. No leaf is gathered whole where the table splits it."""
    shapes, axes = param_shapes(cfg), param_axes(cfg)
    u = apply_norm(p["ln"], x_in, cfg.norm, cfg.norm_eps)
    proj = matmul_cols(u, p["in_proj"], axes["in_proj"], shapes["in_proj"], tp)
    if tp.rules.split_dim(axes["conv_w"], shapes["conv_w"], "model") == 1:
        c0, c1 = tp.part(shapes["conv_w"][1])

        def conv(buf):
            return tp.gather_dim(_conv_last(buf[..., c0:c1], p["conv_w"], p["conv_b"]), -1)
    else:
        w = tp.whole({k: p[k] for k in ("conv_w", "conv_b")}, axes, shapes)

        def conv(buf):
            return _conv_last(buf, w["conv_w"], w["conv_b"])
    y, new = _ssd_step(p, proj, cfg, state, conv)
    y = apply_norm(p["out_norm"], y, cfg.norm, cfg.norm_eps)
    return x_in + matmul_rows(y, p["out_proj"], axes["out_proj"], shapes["out_proj"], tp), new


#: the logical axes of :func:`init_ssm_state`'s leaves (the reference's ``ssm_state_axes``)
SSM_STATE_AXES = {"h": ("batch", None, None, None), "conv": ("batch", None, None)}


def init_ssm_state(cfg, batch: int, dtype=torch.bfloat16, device="cuda"):
    d, di, h, hp, n = dims(cfg)
    return {
        "h": torch.zeros((batch, h, n, hp), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, di + 2 * n), dtype=dtype, device=device),
    }
