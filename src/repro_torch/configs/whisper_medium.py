"""whisper-medium [audio]: 24L d_model=1024 16H d_ff=4096 vocab=51865.
Encoder-decoder; conv frontend is a STUB (input_specs provides precomputed
frame embeddings, (B, 1500, d_model)). [arXiv:2212.04356; unverified]"""

from repro_torch.models.config import Family, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family=Family.AUDIO,
    n_layers=24,                # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    rope_style="none",          # whisper uses learned/sinusoidal positions
    norm="layernorm",
    mlp="gelu",
    encoder_seq_len=1500,
    decoder_pos_len=32768,   # sized for the decode_32k assigned shape (real: 448)
    attn_q_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="whisper-smoke", n_layers=2, n_encoder_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, remat="none",
    encoder_seq_len=16,
)
