"""The port's model kernels: hand-written Hopper kernels for the Pallas TPU
kernels of ``repro/kernels``, each beside its plain PyTorch version
(``ref``); ``ops`` is the entry point the model stack calls."""
