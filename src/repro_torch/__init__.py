"""PyTorch/CUDA port of the CBO (Confidence-Based Offloading) testbed.

Laid out module for module like ``repro`` (the JAX reference), which it
never imports: every module here has one named counterpart there and is
held to it by ``tests/test_torch_*.py``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
