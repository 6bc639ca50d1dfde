"""Configuration: copies of the reference's ``repro.config`` classes with
the same fields and defaults (a test pins them equal).

``DeFTAConfig`` and ``TrainConfig`` configure the simulation; the field
comments of the reference apply, and fields the port does not carry yet
raise ``NotImplementedError`` where the engine is built
(``core.engine.check_supported``). ``MoEConfig``, ``SSMConfig``,
``ModelConfig``, the block kinds and ``reduced`` describe the model zoo
(``repro_torch.configs``) and are verbatim copies.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block kinds used by blocks.py to assemble a layer stack.
ATTN_DENSE = "attn_dense"      # attention + dense MLP
ATTN_MOE = "attn_moe"          # attention + MoE FFN
MAMBA = "mamba"                # Mamba2 SSD block (no attention)
MAMBA_MOE = "mamba_moe"        # Mamba2 block + MoE FFN (Jamba MoE layers)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""
    num_experts: int
    top_k: int
    num_shared_experts: int = 0      # always-on experts (DeepSeekMoE)
    d_expert: int = 0                # per-expert FFN hidden size
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64               # SSD head dim (d_inner / n_heads)
    chunk_size: int = 256            # SSD chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-style transformer/SSM/hybrid/enc-dec model."""
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention options
    qkv_bias: bool = False           # Qwen2.5-style QKV bias
    mlp_gelu: bool = False           # 2-matrix GELU MLP (gpt-bigcode style)
    qk_norm: bool = False            # Qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full causal; >0 = window size
    # FFN / block structure
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: int = 1             # hybrid: 1 attention layer every N layers
                                     # (jamba: 8 -> layers i%8==attn_offset attn)
    attn_offset: int = 0
    moe_period: int = 1              # MoE FFN every N layers (jamba: 2)
    moe_offset: int = 1
    first_dense: int = 0             # leading dense-FFN layers (deepseek/kimi: 1)
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0         # fixed encoder positions (whisper: 1500)
    # vlm
    num_vision_tokens: int = 0       # stub patch embeddings prepended
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # remat/scan
    scan_layers: bool = True
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived block schedule -------------------------------------------
    def block_kind(self, layer_idx: int) -> str:
        """Which block kind layer ``layer_idx`` is."""
        is_attn = True
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            if self.family == "ssm":
                is_attn = False
            else:  # hybrid: attention every attn_period layers
                is_attn = (layer_idx % self.attn_period) == self.attn_offset
        is_moe = self.moe is not None and (
            (layer_idx % self.moe_period) == self.moe_offset
            if self.moe_period > 1 else True)
        if layer_idx < self.first_dense:
            is_moe = False
        if is_attn and is_moe:
            return ATTN_MOE
        if is_attn:
            return ATTN_DENSE
        if is_moe:
            return MAMBA_MOE
        return MAMBA

    def block_schedule(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.num_layers))

    # -- parameter counting (for roofline MODEL_FLOPS) ---------------------
    def param_count(self, active_only: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d                      # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # lm head
        for i in range(self.num_layers):
            kind = self.block_kind(i)
            if kind in (ATTN_DENSE, ATTN_MOE):
                attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                total += attn
            else:  # mamba block (matches models/ssm.init_ssm exactly)
                s = self.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                d_proj = 2 * d_in + 2 * s.d_state + nh
                conv_dim = d_in + 2 * s.d_state
                total += d * d_proj + d_in * d + s.d_conv * conv_dim \
                    + conv_dim + 3 * nh + d_in
            if kind in (ATTN_MOE, MAMBA_MOE):
                m = self.moe
                n_e = m.top_k if active_only else m.num_experts
                per_expert = 3 * d * m.d_expert
                total += n_e * per_expert + m.num_shared_experts * per_expert
                total += d * m.num_experts                # router
            else:
                mats = 2 if self.mlp_gelu else 3
                total += mats * d * self.d_ff             # dense FFN
            total += 2 * d                                # norms
        if self.is_encoder_decoder:
            # encoder layers: self-attn + GELU FFN; decoder adds cross-attn
            enc = self.num_encoder_layers * (
                4 * d * (n_q * hd) + 2 * d * self.d_ff + 2 * d)
            xattn = self.num_layers * (d * (n_q * hd) + 2 * d * (n_kv * hd)
                                       + (n_q * hd) * d + d)
            total += enc + xattn
        return total


def reduced(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 256,
            max_experts: int = 4) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (spec: 2 layers,
    d_model<=512, <=4 experts)."""
    hd = max(32, d_model // max(cfg.num_heads, 1))
    n_heads = max(2, min(cfg.num_heads, d_model // hd))
    n_kv = max(1, min(cfg.num_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=min(moe.num_experts, max_experts),
            top_k=min(moe.top_k, 2),
            num_shared_experts=min(moe.num_shared_experts, 1),
            d_expert=min(moe.d_expert, d_model))
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, d_state=16, head_dim=32, chunk_size=32)
    # keep the hybrid interleave meaningful at 2 layers
    attn_period = min(cfg.attn_period, num_layers) if cfg.attn_period > 1 else 1
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", num_layers=num_layers,
        d_model=d_model, num_heads=n_heads, num_kv_heads=n_kv,
        d_ff=min(cfg.d_ff, 2 * d_model) or 2 * d_model,
        vocab_size=min(cfg.vocab_size, 1024), head_dim=hd,
        moe=moe, ssm=ssm, attn_period=attn_period,
        attn_offset=min(cfg.attn_offset, max(0, attn_period - 1)),
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 64),
        num_vision_tokens=min(cfg.num_vision_tokens, 16),
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        dtype="float32", scan_layers=False, remat=False)


# ---------------------------------------------------------------------------
# DeFTA / federated run configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeFTAConfig:
    """The paper's algorithm knobs (§3)."""
    num_workers: int = 20
    avg_peers: int = 4               # average outdegree (paper: 4)
    num_sampled: int = 2             # |S_i| sampled peers per round (paper: 2)
    topology: str = "random_kout"    # ring | random_kout | erdos | dense
    aggregation: str = "defta"       # defta | defl | uniform | the robust
                                     # rules trimmed_mean | median | krum
    robust_trim: float = 0.25
    use_dts: bool = True
    dts_signal: str = "loss"         # loss | geom | both | corr | all
    dts_geom_weight: float = 1.0
    dts_corr_weight: float = 4.0
    dts_sketch_rounds: int = 8
    dts_sketch_dim: int = 64
    dts_conf_decay: float = 1.0      # cross-device only
    dts_min_obs: int = 2             # cross-device only
    max_staleness: int = 0
    time_machine: bool = True        # §3.3 damage check + backup rollback
    crelu_slope: float = 0.2         # paper Eq. 13
    local_epochs: int = 10           # paper: 10 local epochs per round
    gossip_every: int = 1
    gossip_dtype: str = "float32"    # wire: "float32" | "bfloat16" | "int8"
    gossip_error_feedback: bool = True   # EF21 residuals on a lossy wire
    gossip_wire_round: str = "nearest"   # int8 rounding: nearest | stochastic
    dp_clip: float = 0.0
    dp_sigma: float = 0.0
    dp_update_clip: float = 1.0
    secagg: Optional[str] = None
    secagg_mode: str = "edge"
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"          # the sync engine runs plain SGD
    learning_rate: float = 0.01      # paper default
    weight_decay: float = 0.0
    momentum: float = 0.0
    batch_size: int = 64             # paper default
    epochs: int = 100                # paper: global epochs E
    grad_clip: float = 0.0
    microbatches: int = 1
    seed: int = 0
