"""PyTorch + CUDA port of sdfest-tpu (SDF pose, scale and shape estimation).

The package mirrors the module names of :mod:`sdfest_tpu` so each part has an
obvious counterpart there.  It imports ``torch``, ``numpy`` and ``scipy``
(matplotlib and PyYAML only inside the functions that plot, read or write a
file, and nothing of JAX or of the JAX package); the four
hot kernels (sphere-trace march, trilinear sample, sample-gradient and the
SDF-gradient scatter) are hand-written CUDA C++ under ``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use (:mod:`sdfest_torch.render._build`).
Every kernel has a plain PyTorch twin in :mod:`sdfest_torch.render.kernels`
that CPU tensors take; CUDA tensors always launch the kernel.
"""
