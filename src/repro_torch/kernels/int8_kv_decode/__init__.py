"""int8-KV flash-decode: CUDA kernel (``kernel.py``), plain version (``ref.py``), dispatch (``ops.py``)."""
