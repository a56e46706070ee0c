"""The f32 dense product on the tensor cores in 3xTF32: CUDA kernel
(``kernel.py``), plain version (``ref.py``), dispatch (``ops.py``)."""
