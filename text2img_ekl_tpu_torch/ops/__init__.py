"""Capsule routing: plain PyTorch (``capsule``) and the K1/K2 kernels
behind an autograd Function (``capsule_cuda``)."""
