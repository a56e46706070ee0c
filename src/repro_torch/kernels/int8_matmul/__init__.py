"""W8A8 int8 matmul: CUDA kernel (``kernel.py``), plain version (``ref.py``), dispatch (``ops.py``)."""
