"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1) d_ff=12288
vocab=256000.  RG-LRU + local attention, 1:2 (two recurrent blocks per
local-attention block), window 2048. [arXiv:2402.19427; unverified]"""

from repro_torch.models.config import Family, HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family=Family.HYBRID,
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    attn_window=2048,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rec", "rec", "att"), lru_width=4096,
                        conv_width=4),
    logits_chunk=1024,
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="recurrentgemma-smoke", n_layers=5, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab_size=256, attn_window=8, remat="none",
    logits_chunk=0, hybrid=HybridConfig(pattern=("rec", "rec", "att"),
                                        lru_width=64, conv_width=4),
)
