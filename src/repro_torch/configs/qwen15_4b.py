"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
QKV bias (MHA: kv == q heads). [hf:Qwen/Qwen1.5-0.5B; hf]"""

from repro_torch.models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family=Family.DENSE,
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    mlp="swiglu",
    logits_chunk=1024,
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab_size=256, remat="none", logits_chunk=0,
)
