"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
qk_norm, GQA, explicit head_dim=128. [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family=Family.DENSE,
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    mlp="swiglu",
    param_dtype="bfloat16",
    logits_chunk=1024,
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=160, vocab_size=256, remat="none", logits_chunk=0,
    param_dtype="float32",
)
