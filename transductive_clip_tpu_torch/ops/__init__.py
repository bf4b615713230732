"""Tensor ops of the port: plain PyTorch, plus the wrappers of the kernels
written by hand for Hopper (``cuda_dirichlet``)."""
