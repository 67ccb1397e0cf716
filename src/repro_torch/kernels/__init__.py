"""The port's model kernels: hand-written Hopper kernels for the Pallas TPU
kernels of ``repro/kernels``, each beside its plain PyTorch version
(``ref``); ``ops`` is the entry point the model stack calls.  A kernel
takes plain tensors: on a mesh the model calls it on each device's local
tensors, in explicit local regions (``refuse_dtensor``)."""

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


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise when one of ``tensors`` is a DTensor.  A kernel works on one
    device's memory: on a mesh the model stack hands it each device's local
    tensors inside an explicit local region (``models.layers._attend_sharded``
    for K5, ``models.layers._scan_sharded`` for K8,
    ``models.transformer._kernel_norm`` for K6 and K7).  A DTensor would
    otherwise reach the plain version on the CPU, or ``data_ptr()`` on the
    card, without anyone noticing."""
    from repro_torch.distributed.place import is_dtensor

    if any(t is not None and is_dtensor(t) for t in tensors):
        raise TypeError(
            f"{kernel} takes plain (local) tensors, not a DTensor: call it on "
            "each device's local tensors inside a local region, as the model "
            "stack does")
