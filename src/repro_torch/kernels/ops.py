"""Public entry points of the port's model kernels (the JAX package's
``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version; nothing falls back from the card to the plain version.  The TPU
kernels' ``block_*`` and ``interpret`` arguments have no counterpart: the
Hopper kernels choose their own tiles and mask ragged edges themselves.

  flash_attention   K5, ``repro_torch.kernels.flash_attention``

RMSNorm (K6), fused residual RMSNorm (K7) and the selective scan (K8) come
with the next slice of the port (ROADMAP.md, Queue 1).
"""

from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
