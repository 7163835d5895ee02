"""Tensor ops of the port: math, projection, binning and the compositing
kernels (K1 ``composite``, K2 ``composite_sel``)."""
