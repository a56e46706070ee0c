"""Fused max-softmax -> Platt -> gate."""
