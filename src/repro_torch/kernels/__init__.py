"""Hand-written GPU kernels of the port (CUDA sources in ``../csrc``)."""
