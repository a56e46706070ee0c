"""Plain PyTorch int8-KV decode attention, the oracle of the CUDA kernel.

A copy of ``repro.kernels.int8_kv_decode.ref.decode_attention_ref``
(``ref.py:18-28``): one new token per sequence, q (B, H, D), against int8
ring caches k_q, v_q (B, S, KH, D) with per-token f32 scales k_s, v_s
(B, S); GQA with H = KH·G.  The K scale multiplies the scores and the V
scale the probabilities, in float32; the output is in q's dtype.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def decode_attention_ref(q, k_q, k_s, v_q, v_s) -> torch.Tensor:
    B, H, D = q.shape
    KH = k_q.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).to(F32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_q.to(F32))
    scores = scores * k_s[:, None, None, :] / math.sqrt(D)
    probs = torch.softmax(scores, dim=-1)
    probs_f = probs * v_s[:, None, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", probs_f, v_q.to(F32))
    return out.reshape(B, H, D).to(q.dtype)
