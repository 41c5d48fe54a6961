"""PyTorch / CUDA port of the Pimba reproduction (``repro``).

Module paths mirror the JAX package (``repro/ops/state_update.py`` <->
``repro_torch/ops/state_update.py``).  Plain tensor code is PyTorch; the
Pallas kernels on the served path are CUDA kernels written for Hopper
(``repro_torch/csrc``), built at first use.  Nothing here imports JAX or
the ``repro`` package.
"""
