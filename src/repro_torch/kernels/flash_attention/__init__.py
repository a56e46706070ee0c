"""Flash attention: CUDA kernel (``kernel.py``), plain version (``ref.py``), dispatch (``ops.py``)."""
