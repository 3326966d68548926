"""Device compute: the roll stencil (``stencil``), the packed SWAR engine
(``packed``) and its hand-written CUDA kernel tier (``cuda_packed``, built
by ``cuda_build`` from ``csrc/``)."""
