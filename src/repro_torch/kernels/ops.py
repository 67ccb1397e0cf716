"""Public entry points of the port's model kernels (the JAX package's
``repro/kernels/ops.py``).

A CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
version; nothing falls back from the card to the plain version.  The TPU
kernels' ``block_*``, ``chunk``, ``d_block`` and ``interpret`` arguments
have no counterpart: the Hopper kernels choose their own tiles and mask
ragged edges themselves.

  flash_attention    K5, ``repro_torch.kernels.flash_attention``
  rmsnorm            K6, ``repro_torch.kernels.rmsnorm``
  rmsnorm_residual   K7, ``repro_torch.kernels.rmsnorm``
  selective_scan     K8, ``repro_torch.kernels.selective_scan``
  causal_conv_silu   the Mamba mixer's conv, bias and SiLU,
                     ``repro_torch.kernels.causal_conv``
"""

from repro_torch.kernels.causal_conv import causal_conv_silu  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_residual  # noqa: F401
from repro_torch.kernels.selective_scan import selective_scan  # noqa: F401
