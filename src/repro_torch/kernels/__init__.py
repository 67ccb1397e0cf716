"""The port's model kernels: hand-written Hopper kernels for the Pallas TPU
kernels of ``repro/kernels``, each beside its plain PyTorch version
(``ref``); ``ops`` is the entry point the model stack calls.  A kernel
takes plain tensors: on a mesh the model calls it on each device's local
tensors, in explicit local regions (``refuse_dtensor``).  Each wrapper
counts its launches in ``<wrapper>.launches``; ``launch_counts`` reads
them all."""

from typing import Dict

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


def _wrappers():
    from repro_torch.kernels import causal_conv, flash_attention, rmsnorm, selective_scan

    return (flash_attention.flash_attention, rmsnorm.rmsnorm,
            rmsnorm.rmsnorm_residual, selective_scan.selective_scan,
            causal_conv.causal_conv_silu)


def launch_counts() -> Dict[str, int]:
    """Launches of K5 (``flash_attention``, and by kernel
    ``flash_attention_wgmma`` / ``flash_attention_fma``), K6 (``rmsnorm``),
    K7 (``rmsnorm_residual``), K8 (``selective_scan``) and the Mamba mixer's
    fused conv (``causal_conv``) since the last reset."""
    fa, rn, rr, ss, cc = _wrappers()
    return {"flash_attention": fa.launches, "flash_attention_wgmma": fa.launches_wgmma,
            "flash_attention_fma": fa.launches_fma, "rmsnorm": rn.launches,
            "rmsnorm_residual": rr.launches, "selective_scan": ss.launches,
            "causal_conv": cc.launches}


def reset_launch_counts() -> None:
    """Zero every model kernel's launch counts."""
    from repro_torch.kernels import flash_attention

    flash_attention.reset_launch_counts()
    for wrapper in _wrappers()[1:]:
        wrapper.launches = 0
