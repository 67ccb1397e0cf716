"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384
vocab=257216.  SigLIP frontend is a STUB (input_specs provides 256
precomputed patch embeddings); gemma-style decoder. [arXiv:2407.07726; hf]"""

from repro_torch.models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family=Family.VLM,
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    n_vision_tokens=256,
    logits_chunk=1024,
    attn_q_chunk=256,
)

SMOKE = CONFIG.replace(
    name="paligemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
    d_ff=160, vocab_size=256, remat="none", logits_chunk=0, n_vision_tokens=8,
)
