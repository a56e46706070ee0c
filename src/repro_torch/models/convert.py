"""Parameters of the JAX reference -> a state dict for the port's models.

``params_from_jax`` takes the reference's nested parameter dict with
numpy leaves (``jax.tree.map(np.asarray, params)``; no JAX needed here)
and returns a flat ``{dotted.name: tensor}`` state dict that keeps the
JAX leaf names.  Stacked layers are unstacked: ``layers.all.<leaf>``
(leading axis ``n_layers``) into ``layers.<i>.<leaf>``, and an MoE
model's ``layers.dense`` (its first ``first_k_dense`` layers) and
``layers.moe`` (the rest) into ``layers.0 .. kd-1`` and ``layers.kd ..``.
These leaves change layout, to the ones ``F.conv2d`` and ``F.linear`` take:

- conv ``w`` HWIO -> OIHW;
- dense ``w``, ``mlp.wi`` and ``mlp.wo`` ``(in, out)`` -> ``(out, in)``;
- attention ``wqkv`` ``(3, d, H, Dh)`` -> ``(3·H·Dh, d)`` and ``bqkv``
  ``(3, H, Dh)`` -> ``(3·H·Dh,)``, so the projection's output splits as
  (3, H, Dh);
- attention ``wo`` ``(H, Dh, d)`` -> ``(d, H·Dh)`` (MLA's ``(H, v, d)`` ->
  ``(d, H·v)`` likewise);
- the language models' ``wq``/``wk``/``wv`` ``(d, H, Dh)`` -> ``(H·Dh, d)``,
  ``bq``/``bk``/``bv`` ``(H, Dh)`` -> ``(H·Dh,)``, SwiGLU ``wg``/``wu``
  ``(d, d_ff)`` -> ``(d_ff, d)`` and ``wd`` ``(d_ff, d)`` -> ``(d, d_ff)``,
  and ``unembed`` ``(d, V)`` -> ``(V, d)``;
- MLA's ``w_dkv`` ``(d, r + rope)`` -> ``(r + rope, d)`` and ``w_dq``
  ``(d, q_r)`` -> ``(q_r, d)``; ``w_uk`` ``(r, H, nope)`` -> ``(H·nope, r)``,
  ``w_uv`` ``(r, H, v)`` -> ``(H·v, r)`` and ``w_uq`` ``(q_r, H, qk)`` ->
  ``(H·qk, q_r)``;
- DiT's ``t_embed.w1``/``w2`` ``(in, out)`` -> ``(out, in)``;
- the UNet's ``self_q``/``self_k``/``self_v`` and ``cross_q``/``cross_k``/
  ``cross_v`` ``(in, H, Dh)`` -> ``(H·Dh, in)``, and ``self_o``/``cross_o``
  ``(H, Dh, d)`` -> ``(d, H·Dh)``.

The leaves right under an MoE layer's ``moe`` keep the reference's layout,
which ``torch.bmm`` takes: ``router`` (d, E), ``wg``/``wu``/``wi`` (E, d, f),
``wd``/``wo`` (E, f, d); its ``shared`` and ``dense`` MLPs follow the MLP
rules above.  Every other leaf keeps its shape (``embed`` (V, d), the
norms, MLA's ``kv_norm``/``q_norm``, Swin's ``rel_bias`` and DiT's
``y_embed`` among them).  Values are copied
exactly; bfloat16 leaves stay bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch counterpart in from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _layout(key: str, t: torch.Tensor) -> torch.Tensor:
    if key == "w" and t.ndim == 4:
        return t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if key in ("w", "wi", "wo", "wg", "wu", "wd", "unembed", "w_dkv", "w_dq", "w1", "w2") and t.ndim == 2:
        return t.t()  # (in, out) -> (out, in)
    if key in ("wq", "wk", "wv", "w_uk", "w_uv", "w_uq", "self_q", "self_k", "self_v", "cross_q", "cross_k",
               "cross_v") and t.ndim == 3:
        return t.reshape(t.shape[0], -1).t()  # (in, H, Dh) -> (H·Dh, in)
    if key in ("bq", "bk", "bv"):
        return t.reshape(-1)
    if key == "wqkv":
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])  # (3, d, H, Dh) -> (3·H·Dh, d)
    if key == "bqkv":
        return t.reshape(-1)
    if key in ("wo", "self_o", "cross_o") and t.ndim == 3:
        return t.reshape(-1, t.shape[-1]).t()  # (H, Dh, d) -> (d, H·Dh)
    return t


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: every leaf indexed on its leading axis."""
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i] for k, v in tree.items()}


def _n_layers(tree: dict) -> int:
    leaf = next(iter(tree.values()))
    return _n_layers(leaf) if isinstance(leaf, dict) else np.asarray(leaf).shape[0]


def params_from_jax(tree: dict, prefix: str = "", *, experts: bool = False) -> dict[str, torch.Tensor]:
    """``experts``: ``tree`` is an MoE layer's ``moe`` subtree, whose own
    leaves keep their layout."""
    out: dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if key == "layers" and isinstance(val, dict) and set(val) in ({"all"}, {"dense", "moe"}):
            stacked = [val[g] for g in ("all", "dense", "moe") if g in val]
            layers = [_layer(group, j) for group in stacked for j in range(_n_layers(group))]
            for i, layer in enumerate(layers):
                out.update(params_from_jax(layer, prefix=f"{name}.{i}."))
            continue
        if isinstance(val, dict):
            out.update(params_from_jax(val, prefix=f"{name}.", experts=key == "moe"))
            continue
        t = _to_tensor(val)
        out[name] = (t if experts else _layout(key, t)).contiguous()
    return out
