"""Capsule routing: plain PyTorch (``capsule``), the K1/K2 kernels behind
an autograd Function (``capsule_cuda``) and the batch-blocked variants V
(``capsule_variants``, bench-only); the fused BN+GLU K3 (``bn_glu``) and
the 3x3 conv weight gradient K4 (``conv_dw``)."""
