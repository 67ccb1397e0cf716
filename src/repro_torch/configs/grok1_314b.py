"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""

from repro_torch.models.config import Family, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family=Family.MOE,
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab_size=131072,
    attn_logit_softcap=30.0,    # grok caps attention logits
    mlp="geglu",                # grok uses gelu-gated expert MLPs
    param_dtype="bfloat16",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    logits_chunk=1024,
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="grok-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    vocab_size=256, remat="none", logits_chunk=0, param_dtype="float32",
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
)
