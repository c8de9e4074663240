"""PyTorch/CUDA port of :mod:`repro` for one NVIDIA Hopper GPU.

Mirrors the JAX package module for module (``repro_torch.core.greedy`` is
the counterpart of ``repro.core.greedy``, and so on).  It imports ``torch``
and numpy only: never ``jax`` and nothing of ``repro``.  Entry points run
on the GPU unless the caller passes ``device="cpu"``; on a CUDA tensor every
min-plus product and every flash attention, forward and backward, goes
through a hand-written kernel (:mod:`repro_torch.kernels.minplus`,
:mod:`repro_torch.kernels.flash`), on a CPU tensor through its plain
PyTorch version.
"""
