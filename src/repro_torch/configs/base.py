"""Config schema: architectures, input shapes and run settings.

Port copy of ``repro/configs/base.py``. Every architecture is a
``ModelConfig`` in ``repro_torch/configs/<id>.py`` plus a ``smoke()``
reduction of the same family for CPU tests. Input shapes are the four LM
shapes of the reference; applicability is derived from the architecture
family (DESIGN.md §6).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # experts padded up to a multiple of the EP axis when needed (router
    # masks the padding with -inf); see granite config.
    padded_experts: int | None = None
    # dispatch implementation: "gspmd" (sort-based dispatch, sharding left
    # to GSPMD — the baseline) or "a2a" (shard_map with explicit all_to_all
    # expert parallelism — §Perf iteration 1, see models/moe.py)
    impl: str = "gspmd"

    def experts_padded(self, ep: int = 16) -> int:
        if self.padded_experts is not None:
            return self.padded_experts
        return -(-self.num_experts // ep) * ep


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | xlstm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # override when != d_model // n_heads
    act: str = "silu"  # silu (swiglu) | gelu (geglu)
    qkv_bias: bool = False
    swa_window: int | None = None  # sliding-window attention
    moe: MoESpec | None = None
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0  # hybrid: shared attn block every N ssm blocks
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_len: int = 0
    # vlm (paligemma)
    img_tokens: int = 0
    img_dim: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False  # scale the token embeddings by sqrt(d_model) (gemma)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    dtype: str = "bfloat16"

    # ---- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (DESIGN.md §6 skip table)."""
        return self.family in ("xlstm", "hybrid") or self.swa_window is not None

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline terms)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd, h, k = self.hd, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * (h * hd) + 2 * d * (k * hd) + (h * hd) * d
        if self.act in ("silu", "gelu"):
            mlp_dense = 3 * d * f  # gated
        else:
            mlp_dense = 2 * d * f
        total = emb
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn + mlp_dense + 2 * d)
        elif self.family == "moe":
            e = self.moe.num_experts
            total += self.n_layers * (attn + e * mlp_dense + 2 * d)
        elif self.family == "xlstm":
            # alternating mLSTM / sLSTM blocks, pf=2 up/down projections
            m_blk = 2 * d * (2 * d) + 3 * (2 * d) * self.hd_x + 2 * d
            s_blk = 4 * d * d + 4 * d * d // max(self.n_heads, 1) + 3 * d * d
            total += (self.n_layers // 2) * (m_blk + s_blk) + self.n_layers * 2 * d
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            m_blk = d * (2 * di + 2 * self.ssm_state) + di * d + 3 * di
            n_attn = self.n_layers // max(self.attn_every, 1)
            total += self.n_layers * m_blk + (attn + mlp_dense)  # shared attn
            del n_attn
        elif self.family == "encdec":
            enc = self.enc_layers * (attn + mlp_dense + 4 * d)
            dec = self.n_layers * (2 * attn + mlp_dense + 6 * d)
            total += enc + dec
        return int(total)

    @property
    def hd_x(self) -> int:
        return (2 * self.d_model) // max(self.n_heads, 1)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp_dense = 3 * d * f
        e, k = self.moe.num_experts, self.moe.top_k
        return int(self.param_count() - self.n_layers * (e - k) * mlp_dense)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The assigned shape set, minus documented skips (DESIGN.md §6)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Trainer/server settings shared across the launchers."""

    lr: float = 3e-4
    lr_min_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: int = 0  # 0 = no gradient accumulation
    remat: bool = True
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    grad_compress: str = "none"  # none | topk | int8
    topk_ratio: float = 0.05
    seed: int = 0
