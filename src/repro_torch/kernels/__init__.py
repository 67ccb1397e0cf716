"""The port's model kernels: hand-written Hopper kernels for the Pallas TPU
kernels of ``repro/kernels``, each beside its plain PyTorch version
(``ref``); ``ops`` is the entry point the model stack calls."""

import torch


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise when a call of ``kernel`` would need its backward: autograd is
    on and one of ``tensors`` requires grad.  The kernels have none, as the
    JAX package's Pallas kernels have no JVP rule (``jax.grad`` through them
    raises), and the wrappers never hand such a call to their plain
    versions: train with ``attn_impl="xla"``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            f"{kernel} has no backward (nor has the JAX package's Pallas "
            "kernel); differentiate the model with attn_impl='xla'")
