"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) d_ff=1408 (per routed
expert) vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.models.config import Family, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family=Family.MOE,
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=151936,
    qkv_bias=True,
    mlp="swiglu",
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408,
                  n_shared_experts=4, d_ff_shared=1408),
    logits_chunk=1024,
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="qwen2moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    vocab_size=256, remat="none", logits_chunk=0,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=32,
                  n_shared_experts=2, d_ff_shared=32),
)
