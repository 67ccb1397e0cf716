"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
RoPE 2d (partial/interleaved rotary over half the head dim), GQA.
[arXiv:2406.12793; hf]"""

from repro_torch.models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family=Family.DENSE,
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope_style="half",          # GLM 2d rotary: first half of head_dim, interleaved
    qkv_bias=True,              # chatglm uses qkv bias (add_qkv_bias=True)
    mlp="swiglu",
    norm="rmsnorm",
    logits_chunk=1024,
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="chatglm3-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=256, remat="none", logits_chunk=0,
)
