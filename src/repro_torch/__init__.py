"""PyTorch / CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

The package mirrors ``src/repro`` (configs, models, quant, kernels,
serving, launch) and imports only ``torch``, numpy and the standard
library: nothing of JAX and nothing of ``repro``.  The Pallas kernels on
the serving path are CUDA kernels written for ``sm_90a`` under
``kernels/csrc``; every kernel wrapper takes its plain PyTorch version
for CPU tensors.
"""
