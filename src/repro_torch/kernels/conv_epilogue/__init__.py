"""A ResNet conv's epilogue (frozen-BN affine, residual, ReLU, SAME pad) in one pass:
CUDA kernel (``kernel.py``), plain version (``ref.py``), dispatch (``ops.py``)."""
