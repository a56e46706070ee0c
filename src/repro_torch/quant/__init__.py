"""Quantization (the fast tier's "NPU" numerics)."""
