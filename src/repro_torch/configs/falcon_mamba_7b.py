"""falcon-mamba-7b [ssm]: 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16.  Mamba-1 architecture. [arXiv:2410.05355; unverified]"""

from repro_torch.models.config import Family, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family=Family.SSM,
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    rope_style="none",
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    logits_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="falcon-mamba-smoke", n_layers=2, d_model=64, vocab_size=256,
    remat="none", logits_chunk=0, ssm=SSMConfig(state_dim=4, conv_width=4,
                                                expand=2),
)
