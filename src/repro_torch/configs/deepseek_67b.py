"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400.  llama-style architecture. [arXiv:2401.02954; hf]"""

from repro_torch.models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family=Family.DENSE,
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    mlp="swiglu",
    param_dtype="bfloat16",
    logits_chunk=1024,
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="deepseek-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab_size=256, remat="none", logits_chunk=0,
    param_dtype="float32",
)
