"""Partition-point catalog: where a model can be cut, and what a cut ships
(port of ``repro.split.points``; host numpy, as the reference).

A *cut point* is a block boundary: the device runs blocks ``[0, block)``,
quantizes the activation at the boundary to int8 (the ``quant/quantize.py``
wire format: int8 values and one float32 scale per leading row,
``quantize_tensor(x, axis=-1)``), ships it, and the server runs blocks
``[block, n_blocks)``.  Each ``CutPoint`` carries the activation shape at
the boundary, its float32 bytes (``raw_nbytes``), its exact int8 + scales
wire bytes (``payload_nbytes``) and the forward FLOPs of the prefix and of
the whole model, in the ``2 * params * positions`` convention, which
``split/costs.py`` turns into device-prefix time and a server-suffix
fraction.  Catalogs come from the model configs: ViT blocks are
homogeneous, ResNet stages shrink spatially as channels grow, Swin stages
merge patches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.configs.base import ResNetConfig, SwinConfig, ViTConfig, get_arch

_SCALE_BYTES = 4  # float32 scale per quantization group


def activation_payload_nbytes(shape: Sequence[int], *, bits: int = 8,
                              scale_bytes: int = _SCALE_BYTES) -> int:
    """Exact wire bytes for ``quantize_tensor(x, axis=-1)`` of an activation.

    int8 stores one byte per element; symmetric per-channel quantization
    along the last axis keeps one float32 scale per *leading row*
    (``scale.shape == shape[:-1] + (1,)``), so the payload is

        prod(shape) * (bits/8)  +  prod(shape[:-1]) * scale_bytes
    """
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return n * bits // 8 + rows * scale_bytes


def qtensor_nbytes(q) -> int:
    """Wire bytes of a materialized ``quant.quantize.QTensor`` (values +
    scales).  ``activation_payload_nbytes`` is the analytic twin; tests pin
    them equal on real tensors."""
    return sum(int(t.numel() * t.element_size()) for t in (q.values, q.scale))


@dataclass(frozen=True)
class CutPoint:
    """One block boundary of one model at one input resolution."""

    cut_id: int  # index within the catalog
    name: str  # e.g. "vit-s16/block4"
    block: int  # device runs blocks [0, block)
    n_blocks: int
    act_shape: tuple  # activation tensor shape at the boundary
    raw_nbytes: int  # float32 activation bytes
    payload_nbytes: int  # int8 + per-row f32 scales (the wire format)
    prefix_flops: float  # forward FLOPs of blocks [0, block)
    total_flops: float  # forward FLOPs of all blocks

    @property
    def suffix_flops(self) -> float:
        return self.total_flops - self.prefix_flops

    @property
    def suffix_fraction(self) -> float:
        return self.suffix_flops / max(self.total_flops, 1e-30)

    @property
    def compression(self) -> float:
        """raw float32 bytes / shipped bytes (≈4 for int8+scales)."""
        return self.raw_nbytes / max(self.payload_nbytes, 1)


@dataclass(frozen=True)
class CutCatalog:
    model: str
    family: str  # "vit" | "resnet" | "swin"
    img_res: int
    points: tuple  # tuple[CutPoint, ...]
    total_flops: float

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self):
        return iter(self.points)

    def payload_bytes(self) -> np.ndarray:
        return np.array([p.payload_nbytes for p in self.points], dtype=np.float64)

    def subsample(self, max_cuts: int) -> "CutCatalog":
        """Evenly thin the catalog to at most ``max_cuts`` points (planner
        action grids are O(A) per frontier state; a handful of well-spread
        cuts captures the frontier)."""
        if max_cuts >= len(self.points) or max_cuts <= 0:
            return self
        idx = np.unique(np.linspace(0, len(self.points) - 1, max_cuts).round().astype(int))
        pts = tuple(
            CutPoint(cut_id=i, name=p.name, block=p.block, n_blocks=p.n_blocks,
                     act_shape=p.act_shape, raw_nbytes=p.raw_nbytes,
                     payload_nbytes=p.payload_nbytes, prefix_flops=p.prefix_flops,
                     total_flops=p.total_flops)
            for i, p in enumerate(self.points[j] for j in idx))
        return CutCatalog(self.model, self.family, self.img_res, pts, self.total_flops)


# --------------------------------------------------------------------------- #
# Per-family block walks.  Each yields (name, act_shape, block_flops) in
# forward order; a cut is legal after every block except the last (cutting
# after the final block would ship logits — that is just "run locally").
# --------------------------------------------------------------------------- #


def _walk_vit(cfg: ViTConfig, img_res: int):
    n_tok = (img_res // cfg.patch) ** 2 + 1 + (1 if cfg.distill_token else 0)
    d = cfg.d_model
    per_layer = 4 * d * d + 2 * d * cfg.d_ff
    for b in range(cfg.n_layers):
        yield f"{cfg.name}/block{b + 1}", (n_tok, d), 2.0 * per_layer * n_tok


def _walk_resnet(cfg: ResNetConfig, img_res: int):
    cin = cfg.width
    for i, dep in enumerate(cfg.depths):
        mid = cfg.width * 2 ** i
        cout = mid * 4
        h = img_res // (4 * 2 ** i)  # stem /4, then /2 per stage
        for b in range(dep):
            params = cin * mid + 9 * mid * mid + mid * cout
            if cin != cout:
                params += cin * cout  # downsample projection
            yield f"{cfg.name}/s{i + 1}b{b + 1}", (h, h, cout), 2.0 * params * h * h
            cin = cout


def _walk_swin(cfg: SwinConfig, img_res: int):
    r0 = img_res // cfg.patch
    for i, (dep, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        r = r0 // 2 ** i
        tokens = r * r
        per_block = 4 * dim * dim + 2 * dim * 4 * dim
        merge = 2.0 * (4 * cfg.dims[i - 1] * dim) * tokens if i > 0 else 0.0
        for b in range(dep):
            flops = 2.0 * per_block * tokens + (merge if b == 0 else 0.0)
            yield f"{cfg.name}/s{i + 1}b{b + 1}", (tokens, dim), flops


_WALKS = {ViTConfig: ("vit", _walk_vit), ResNetConfig: ("resnet", _walk_resnet),
          SwinConfig: ("swin", _walk_swin)}


def catalog_for(arch: Union[str, ViTConfig, ResNetConfig, SwinConfig], *,
                img_res: Optional[int] = None, smoke: bool = False,
                max_cuts: Optional[int] = None) -> CutCatalog:
    """Build the cut catalog for a model family.

    ``arch`` is a registry id (``"vit-s16"``, ``"resnet-50"``, ``"swin-b"``)
    or a config instance; ``img_res`` defaults to the config's native
    resolution.  ``max_cuts`` evenly thins the catalog (the planner's action
    grid is {local} ∪ {frame@r} ∪ {features@cut}, so every kept cut is a
    planner column).
    """
    if isinstance(arch, str):
        spec = get_arch(arch)
        cfg = spec.smoke if smoke else spec.full
    else:
        cfg = arch
    try:
        family, walk = _WALKS[type(cfg)]
    except KeyError:
        raise ValueError(
            f"no split catalog for {type(cfg).__name__}; supported families: "
            f"ViT, ResNet, Swin") from None
    res = int(img_res or cfg.img_res)

    blocks = list(walk(cfg, res))
    total = float(sum(f for _, _, f in blocks))
    points, prefix = [], 0.0
    for k, (name, shape, flops) in enumerate(blocks):
        prefix += flops
        if k == len(blocks) - 1:
            break  # cut after the last block == run locally
        raw = int(np.prod(shape)) * 4
        points.append(CutPoint(
            cut_id=len(points), name=name, block=k + 1, n_blocks=len(blocks),
            act_shape=tuple(int(s) for s in shape), raw_nbytes=raw,
            payload_nbytes=activation_payload_nbytes(shape),
            prefix_flops=prefix, total_flops=total))
    cat = CutCatalog(model=cfg.name, family=family, img_res=res,
                     points=tuple(points), total_flops=total)
    return cat.subsample(max_cuts) if max_cuts else cat
