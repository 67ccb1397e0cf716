"""Model configuration schema covering all assigned architecture families.

One ``ModelConfig`` describes any of: dense decoder LMs (llama/qwen/chatglm/
deepseek), MoE decoders (grok/qwen2-moe), SSM stacks (falcon-mamba), hybrid
recurrent/local-attention stacks (recurrentgemma), encoder-decoder audio
models (whisper) and vision-prefixed LMs (paligemma).

The schema is the JAX package's, field for field, so a config carries
across unchanged.  In the port:

- ``attn_impl="xla"`` means the plain PyTorch attention
  (``repro_torch.models.layers._sdpa``) and ``attn_impl="pallas"`` means
  the hand-written flash-attention kernel K5
  (``repro_torch.kernels.flash_attention``), taken where the JAX package
  takes its Pallas kernel.  For the SSM family, which has no attention,
  ``"pallas"`` selects the kernels K6-K8 (RMSNorm, fused residual RMSNorm,
  selective scan; ``repro_torch.models.transformer``) and ``"xla"`` the
  plain blocks -- the schema cannot gain a field, so this switch does;
- ``remat`` and ``scan_layers`` have no effect: the port's path is
  inference only (nothing to rematerialize) and its layer loop is a Python
  loop either way.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    SSM = "ssm"
    HYBRID = "hybrid"
    AUDIO = "audio"     # encoder-decoder, audio frontend stub
    VLM = "vlm"         # vision-prefixed decoder, patch frontend stub


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0           # per-expert hidden dim
    n_shared_experts: int = 0      # always-active shared experts
    d_ff_shared: int = 0           # per-shared-expert hidden dim
    router_jitter: float = 0.0
    impl: str = "gmm"   # gmm (sort+ragged_dot) | dense (all experts) | capacity
    capacity_factor: float = 1.25  # capacity impl: C = Tg*k*cf/E (drops beyond)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 = ceil(d_model / 16)
    scan_chunk: int = 256          # chunked-scan length (memory/compile knob)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    # Block pattern period, e.g. ("rec", "rec", "att") for RecurrentGemma 1:2.
    pattern: Tuple[str, ...] = ("rec", "rec", "att")
    lru_width: int = 0             # 0 = d_model
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 = d_model // n_heads
    # --- attention options ---------------------------------------------- #
    rope_style: str = "full"       # full | half (partial/interleaved "2d") | none
    rope_theta: float = 10000.0
    qk_norm: bool = False          # qwen3-style per-head RMS on q,k
    qkv_bias: bool = False         # qwen1.5-style
    attn_window: Optional[int] = None   # sliding-window size (local attention)
    attn_logit_softcap: Optional[float] = None
    attn_q_chunk: int = 0          # blockwise attention q-chunk (0 = off)
    # --- MLP / norms ------------------------------------------------------ #
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scale
    # --- family extensions ------------------------------------------------ #
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # encoder-decoder (audio): encoder layer count + frontend sequence length
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500    # whisper: 30 s -> 1500 frames after conv
    decoder_pos_len: int = 0       # learned decoder position table (audio)
    # vlm: number of vision prefix tokens (SigLIP stub output length)
    n_vision_tokens: int = 0
    # --- numerics / execution --------------------------------------------- #
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # none | full | dots
    logits_chunk: int = 0          # 0 = unchunked cross-entropy
    attn_impl: str = "xla"         # xla | pallas
    scan_layers: bool = True

    # ------------------------------------------------------------------ #

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def is_attention_free(self) -> bool:
        return self.family == Family.SSM

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k decode is runnable."""
        return self.family in (Family.SSM, Family.HYBRID)

    @property
    def has_encoder(self) -> bool:
        return self.family == Family.AUDIO

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ----- parameter counts (analytic; used for MODEL_FLOPS) ------------- #

    def param_counts(self) -> Tuple[float, float]:
        """(total_params, active_params).  Active differs only for MoE."""
        d, v = self.d_model, self.vocab_size
        embed = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> float:
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            return p

        def mlp_params(d_ff: int) -> float:
            n_mats = 3 if self.mlp in ("swiglu", "geglu") else 2
            return n_mats * d * d_ff

        norms = 2 * d  # two per block
        total = active = 0.0

        if self.family in (Family.DENSE, Family.VLM):
            per_layer = attn_params() + mlp_params(self.d_ff) + norms
            total = active = self.n_layers * per_layer
        elif self.family == Family.AUDIO:
            enc = self.n_encoder_layers * (attn_params() + mlp_params(self.d_ff) + norms)
            # decoder blocks add cross-attention
            dec = self.n_layers * (2 * attn_params() + mlp_params(self.d_ff) + 3 * d)
            total = active = enc + dec
        elif self.family == Family.MOE:
            m = self.moe
            assert m is not None
            router = d * m.n_experts
            experts_total = m.n_experts * mlp_params(m.d_ff_expert)
            experts_active = m.top_k * mlp_params(m.d_ff_expert)
            shared = m.n_shared_experts * mlp_params(m.d_ff_shared)
            if m.n_shared_experts:
                shared += d * d  # shared-expert gate
            per_layer_total = attn_params() + router + experts_total + shared + norms
            per_layer_active = attn_params() + router + experts_active + shared + norms
            total = self.n_layers * per_layer_total
            active = self.n_layers * per_layer_active
        elif self.family == Family.SSM:
            s = self.ssm
            assert s is not None
            d_in = s.expand * d
            dt_rank = s.dt_rank or -(-d // 16)
            per_layer = (
                d * 2 * d_in                   # in_proj (x and gate)
                + s.conv_width * d_in          # depthwise conv
                + d_in * (dt_rank + 2 * s.state_dim)  # x -> dt,B,C
                + dt_rank * d_in               # dt_proj
                + d_in * s.state_dim           # A
                + d_in                         # D
                + d_in * d                     # out_proj
                + d                            # norm
            )
            total = active = self.n_layers * per_layer
        elif self.family == Family.HYBRID:
            h = self.hybrid
            assert h is not None
            w = h.lru_width or d
            rec_layer = (
                2 * d * w                      # in_proj x + gate branches
                + h.conv_width * w             # temporal conv
                + 2 * w * w // 8               # RG-LRU input/recurrence gates (block-diag, 8 heads)
                + w                            # LRU decay params
                + w * d                        # out_proj
            )
            att_layer = attn_params()
            n_rec = sum(1 for i in range(self.n_layers)
                        if h.pattern[i % len(h.pattern)] == "rec")
            n_att = self.n_layers - n_rec
            per_mlp = mlp_params(self.d_ff) + norms
            total = active = (
                n_rec * (rec_layer + per_mlp) + n_att * (att_layer + per_mlp)
            )
        else:  # pragma: no cover
            raise ValueError(self.family)

        total += embed
        active += embed
        if self.family == Family.VLM and self.n_vision_tokens:
            pass  # SigLIP frontend is a stub; its params are out of scope
        return float(total), float(active)
