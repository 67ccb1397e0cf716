"""The model stack, ported to PyTorch: config schema, layers and the
transformer (dense, MoE, SSM, hybrid, audio and VLM families)."""
