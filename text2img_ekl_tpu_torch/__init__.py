"""text2img_ekl_tpu_torch: the PyTorch and CUDA port of text2img_ekl_tpu.

The JAX package beside it is the reference. This package mirrors its
layout (ops, nn, models, train, io_utils, data, config) and imports
nothing of JAX or of the JAX package. Its
hand-written Hopper kernels live under ``csrc/`` and are built with
``nvcc`` on first use (``ops/_build.py``).
"""
