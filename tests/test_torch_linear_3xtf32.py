"""The 3xTF32 dense product (``kernels/linear_3xtf32``) and its routing
(``models/layers.py::linear``).

Tolerance, on the CPU and on the card alike: each output element within
2^-20 (9.5e-7) of ``sum_k |x_ik||w_jk| + |b_j|`` of the float64 product.
The split (each half rounded to TF32 to nearest) leaves each TF32 pair
within 2^-22 of its f32 operand and drops small·small' (at most 2^-22 of
the term), so a term is off by at most 3·2^-22 of |x||w|; the f32 sums add
little at these K.  The plain version reads at most 3.0e-7 of that scale
here, cuBLAS's f32 product 3.6e-7 on an H100.  One TF32 product, the
precision below, reads 2.4e-5 to 2.8e-4 and fails it (the control).

The ``cuda`` tests run the kernel: against float64 at the same shapes,
its mean error beside cuBLAS's f32 product's, its refusals, its launches (162 a DINOv3 ViT-H+ forward), and DINOv3 ViT-H+,
DeiT-B and Swin-B FULL logits against the same models with ``F.linear``
(cuBLAS, f32, TF32 off) within each benchmark configuration's
``slow_logits`` limit.  This file imports neither JAX nor the JAX package.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.deit_b import FULL as DEIT_B
from repro_torch.configs.dinov3_vith16plus import FULL as DINOV3
from repro_torch.configs.dinov3_vith16plus import SMOKE as DINOV3_SMOKE
from repro_torch.configs.swin_b import FULL as SWIN_B
from repro_torch.kernels.linear_3xtf32 import kernel as lk
from repro_torch.kernels.linear_3xtf32.ref import linear_3xtf32_ref, linear_tf32_ref, split_tf32, tf32_round
from repro_torch.models import layers
from repro_torch.models.dinov3 import DINOv3
from repro_torch.models.swin import Swin
from repro_torch.models.vit import ViT

TOL = 2.0**-20
SOURCE = Path(lk.__file__).parent / "csrc" / "linear_3xtf32.cu"
ROWS = (9, 201, 1407, 2412)


def _products(model: str, cfg) -> dict:
    """{(N, K): name} of a model's dense products, one entry a shape."""
    if model == "dinov3":
        d, f = cfg.d_model, cfg.d_ff
        named = [("qkv", 3 * d, d), ("wo", d, d), ("wg_wu", f, d), ("wd", d, f),
                 ("stem", d, cfg.patch**2 * 3), ("head", cfg.n_classes, d)]
    elif model == "deitb":
        d, f = cfg.d_model, cfg.d_ff
        named = [("qkv", 3 * d, d), ("wo_stem", d, d), ("wi", f, d), ("mlp_wo", d, f), ("head", cfg.n_classes, d)]
    else:
        named = [("stem", cfg.dims[0], cfg.patch**2 * 3), ("head", cfg.n_classes, cfg.dims[-1])]
        for i, c in enumerate(cfg.dims):
            named += [(f"s{i}_qkv", 3 * c, c), (f"s{i}_wo", c, c), (f"s{i}_wi", 4 * c, c), (f"s{i}_mlp_wo", c, 4 * c)]
            if i + 1 < len(cfg.dims):
                named.append((f"s{i}_merge", cfg.dims[i + 1], 4 * c))
    out = {}
    for name, N, K in named:
        out.setdefault((N, K), f"{model}_{name}")
    return out


SHAPES = [(name, N, K) for model, cfg in (("dinov3", DINOV3), ("deitb", DEIT_B), ("swinb", SWIN_B))
          for (N, K), name in _products(model, cfg).items()]
SHAPE_IDS = [f"{name}-{N}x{K}" for name, N, K in SHAPES]


def _operands(M, N, K, seed, device="cpu"):
    """x ~ N(0, 1), w ~ N(0, 1/K) (the models' fan-in draw), b ~ N(0, 0.02²)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((M, K), dtype=np.float32), device=device)
    w = torch.as_tensor((rng.standard_normal((N, K), dtype=np.float32) / np.float32(math.sqrt(K))), device=device)
    b = torch.as_tensor(rng.standard_normal(N, dtype=np.float32) * np.float32(0.02), device=device)
    return x, w, b


def _scaled_err(y, x, w, b) -> float:
    """max over elements of |y - y64| / (|x|·|w|ᵀ + |b|), the product in
    float64 and the scale in float32 (a scale needs no more)."""
    want = x.double() @ w.double().T
    scale = x.abs() @ w.abs().T
    if b is not None:
        want, scale = want + b.double(), scale + b.abs()
    return float(((y.double() - want).abs() / scale.double()).max())


def test_shapes_cover_each_models_products():
    """DINOv3's seven products (wg and wu share a shape), DeiT-B's six
    (its stem shares wo's) and Swin-B's 4 a stage, 3 merges, stem, head."""
    assert len(_products("dinov3", DINOV3)) == 6 and (DINOV3.d_ff, DINOV3.d_model) in _products("dinov3", DINOV3)
    assert len(_products("deitb", DEIT_B)) == 5
    assert len(_products("swinb", SWIN_B)) == 4 * len(SWIN_B.dims) + (len(SWIN_B.dims) - 1) + 2
    assert all(N % 4 == 0 and K % 4 == 0 for _, N, K in SHAPES)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("name,N,K", SHAPES, ids=SHAPE_IDS)
def test_plain_version_against_float64(name, N, K, M, bias):
    x, w, b = _operands(M, N, K, seed=N * 7 + K + M)
    b = b if bias else None
    y = linear_3xtf32_ref(x, w, b)
    assert y.dtype == torch.float32 and y.shape == (M, N)
    assert _scaled_err(y, x, w, b) <= TOL


@pytest.mark.parametrize("name,N,K", SHAPES, ids=SHAPE_IDS)
def test_single_tf32_fails_the_tolerance(name, N, K):
    """The control: one TF32 product, each operand rounded to TF32, is 20x or
    more past the tolerance at every shape."""
    x, w, b = _operands(201, N, K, seed=N + K)
    assert _scaled_err(linear_tf32_ref(x, w, b), x, w, b) > 20 * TOL


def test_split_is_exact_and_tf32():
    """f32 values of magnitude 2^-100 and up (the split's bound is
    relative; below that small is subnormal and loses more, far below any
    product here)."""
    rng = np.random.default_rng(3)
    v = torch.as_tensor(np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096),
                                        [0.0, -0.0, 1.0, -1.5, 3.4e38, 2.0**-100]]).astype(np.float32))
    big, small = split_tf32(v)
    for t in (big, small):
        assert int((t.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # v - big is exact in f32, and big + small within 2^-22 of v
    assert torch.equal((v - big).double(), v.double() - big.double())
    assert bool(((v.double() - big.double() - small.double()).abs() <= 2.0**-22 * v.double().abs()).all())
    assert torch.equal(tf32_round(big), big)


def test_plain_version_sums_small_terms_first():
    """x_small·W_bigᵀ + x_big·W_smallᵀ, then x_big·W_bigᵀ, then b."""
    x, w, b = _operands(5, 12, 16, seed=1)
    (xb, xs), (wb, ws) = split_tf32(x), split_tf32(w)
    want = (F.linear(xs, wb) + F.linear(xb, ws)) + F.linear(xb, wb) + b
    assert torch.equal(linear_3xtf32_ref(x, w, b), want)


# ---- routing: models/layers.py::linear ------------------------------------- #

def test_linear_on_the_cpu_is_f_linear_and_launches_nothing():
    x, w, b = _operands(7, 16, 32, seed=2)
    before = lk.linear_3xtf32.launches
    for args in ((x, w, b), (x, w), (x.view(7, 1, 32), w, b), (x.bfloat16(), w.bfloat16(), b.bfloat16())):
        assert torch.equal(layers.linear(*args), F.linear(*args))
    assert lk.linear_3xtf32.launches == before


@pytest.mark.parametrize("case", ["f32", "bf16", "f16", "grad_x", "grad_w", "grad_b", "grad_off", "k_not_4",
                                  "n_not_4", "empty"])
def test_linear_sends_to_the_kernel_only_what_it_takes(case):
    """The rule, on what a CUDA input would show: f32, nothing for
    autograd to record, K and N multiples of 4, rows to multiply."""
    M, N, K = 5, 8, 12
    if case == "k_not_4":
        K = 10
    if case == "n_not_4":
        N = 6
    if case == "empty":
        M = 0
    x, w, b = _operands(M, N, K, seed=3)
    if case in ("bf16", "f16"):
        x, w, b = (t.to(getattr(torch, "bfloat16" if case == "bf16" else "float16")) for t in (x, w, b))
    t = {"grad_x": x, "grad_w": w, "grad_b": b, "grad_off": x}.get(case)
    if t is not None:
        t.requires_grad_(True)
    with torch.set_grad_enabled(case != "grad_off"):
        assert layers.kernel_takes(x, w, b) == (case in ("f32", "grad_off"))


def test_tile_plan_fills_the_waves():
    """One block a SM (every width's ring takes 190-230 KB): at DINOv3
    ViT-H+'s ~2,000 rows N = 1,280 takes 160 columns (128 blocks, one
    wave) where 128 x 128 would take 160 blocks in two; the measured
    fastest width on an H100 at each of these shapes (PERF.md §6)."""
    assert lk.tile_plan(2010, 1280, 132) == 160 and lk.n_tiles(2010, 1280, 160) <= 132
    for (M, N), bn in {(2010, 3840): 160, (2010, 5120): 160, (2412, 1280): 64, (201, 1280): 64,
                       (1980, 3072): 128, (1980, 2304): 160}.items():
        assert lk.tile_plan(M, N, 132) == bn, (M, N)
    for M in (1, 9, 201, 1407, 2412, 100_000):
        for N in (4, 100, 1000, 1280, 3840, 5120):
            assert lk.tile_plan(M, N, 132) in lk.BNS


def test_kernel_constants_match_the_source():
    src = SOURCE.read_text()
    assert re.search(rf"constexpr int BM = {lk.BM};", src) and re.search(rf"constexpr int BK = {lk.BK};", src)
    launch = src[src.index('extern "C" int linear_3xtf32_launch'):]
    assert tuple(int(n) for n in re.findall(r"case (\d+): err = run<", launch)) == lk.BNS
    for bn in lk.BNS:
        assert f"wgmma.mma_async.sync.aligned.m64n{bn}k8.f32.tf32.tf32" in src


def test_a_fragments_read_the_tma_swizzle_without_bank_conflicts():
    """The multipliers' A-fragment address (``r*128 + ((chunk ^ g) << 4) +
    4t``, read from the source) is where TMA's 128-byte swizzle put element
    (r, c) of the 128 x 32 x tile, each warpgroup's fragments cover its 64
    rows once a k-step, and a warp's 32 loads hit 32 banks."""
    src = SOURCE.read_text()
    assert "a_tile + r * 128 + ((chunk ^ g) << 4) + 4 * t" in src
    assert "const int r0 = 64 * (wg - 1) + 16 * warp + g;" in src
    for wg in (1, 2):
        for kk in range(4):
            seen = set()
            for i in range(4):
                for warp in range(4):
                    banks = set()
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        r = 64 * (wg - 1) + 16 * warp + g + 8 * (i % 2)
                        chunk = 2 * kk + i // 2
                        addr = r * 128 + ((chunk ^ g) << 4) + 4 * t
                        c = 8 * kk + t + 4 * (i // 2)  # a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
                        linear = r * 128 + 4 * c
                        assert addr == linear ^ (((linear >> 7) & 7) << 4)
                        seen.add((r, c))
                        banks.add((addr // 4) % 32)
                    assert len(banks) == 32
            assert seen == {(r, c) for r in range(64 * (wg - 1), 64 * wg) for c in range(8 * kk, 8 * kk + 8)}


# ---- on the card ------------------------------------------------------------ #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("name,N,K", SHAPES, ids=SHAPE_IDS)
def test_kernel_against_float64(cuda_device, name, N, K, M, bias):
    x, w, b = _operands(M, N, K, seed=N * 7 + K + M, device=cuda_device)
    b = b if bias else None
    before = lk.linear_3xtf32.launches
    with torch.no_grad():
        y = lk.linear_3xtf32(x, w, b)
    torch.cuda.synchronize()
    assert lk.linear_3xtf32.launches == before + 1 and y.shape == (M, N)
    assert _scaled_err(y, x, w, b) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K,ratio", [(20, 128, 64, 2.5), (20, 64, 128, 2.5), (20, 64, 32, 2.5),
                                         (256, 128, 64, 2.5), (256, 512, 512, 1.0), (2010, 1280, 1280, 1.0)])
def test_kernel_error_beside_cublas_f32(cuda_device, M, N, K, ratio):
    """The kernel's mean error over sum |x||w| + |b| against cuBLAS's f32
    product (``F.linear``, TF32 off) on the same inputs: within 2.5 times
    at K = 32-128 (language-model widths, where cuBLAS's few roundings make
    it most exact) and below it from K = 512.  The tensor cores cut their
    sums toward zero; 64 of K summed before each FADD read 2.2-3.3 times
    at K <= 128 and 1.3 times at K = 512 on an H100."""
    x, w, b = _operands(M, N, K, seed=M + N + K, device=cuda_device)
    x = x + 0.3
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            y, ref = lk.linear_3xtf32(x, w, b), F.linear(x, w, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    want = x.double() @ w.double().T + b.double()
    scale = (x.abs() @ w.abs().T + b.abs()).double()
    mine, cublas = (float(((t.double() - want).abs() / scale).mean()) for t in (y, ref))
    assert mine <= ratio * cublas, (mine, cublas)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", lk.BNS)
def test_kernel_every_width_ragged_edges_and_strided_rows(cuda_device, bn):
    """Every width at ragged M, N and K (TMA's zero fill, the masked
    store), rows read in place from a strided view, and the same bits
    from one width to the next (the sums' order does not depend on BN)."""
    x, w, b = _operands(300, 100, 36, seed=bn, device=cuda_device)
    wide = torch.zeros(300, 44, device=cuda_device)
    wide[:, :36] = x
    view = wide[:, :36]
    assert not view.is_contiguous()
    y = lk.linear_3xtf32(view, w, b, bn=bn)
    assert _scaled_err(y, x, w, b) <= TOL
    assert torch.equal(y, lk.linear_3xtf32(x, w, b, bn=64))


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda_device):
    x, w, b = _operands(8, 16, 32, seed=5, device=cuda_device)
    bad = [((x.cpu(), w.cpu(), b.cpu()), ValueError), ((x.double(), w, b), TypeError), ((x, w.half(), b), TypeError),
           ((x, w, b[:8]), ValueError), ((x[:, :30], w[:, :30], b), ValueError),
           ((x, w[:14], b[:14]), ValueError), ((x.t(), w, b), ValueError), ((x, w.t().contiguous().t(), b), ValueError),
           ((x.view(2, 4, 32), w, b), ValueError), ((x[:0], w, b), ValueError),
           ((torch.empty(8 * 32 + 1, device=cuda_device)[1:].view(8, 32), w, b), ValueError)]
    before = lk.linear_3xtf32.launches
    for args, err in bad:
        with pytest.raises(err):
            lk.linear_3xtf32(*args)
    with pytest.raises(ValueError):
        lk.linear_3xtf32(x, w, b, bn=80)
    with pytest.raises(RuntimeError, match="no backward"):
        lk.linear_3xtf32(x.requires_grad_(True), w, b)
    assert lk.linear_3xtf32.launches == before


@pytest.mark.cuda
def test_linear_on_the_card_launches_only_what_it_takes(cuda_device):
    x, w, b = _operands(7, 16, 32, seed=6, device=cuda_device)
    before = lk.linear_3xtf32.launches
    with torch.no_grad():
        layers.linear(x.view(7, 1, 32), w, b)
        layers.linear(x, w)
    assert lk.linear_3xtf32.launches == before + 2
    layers.linear(x.bfloat16(), w.bfloat16(), b.bfloat16())
    layers.linear(x[:, :30], w[:, :30], b)
    w.requires_grad_(True)
    layers.linear(x, w, b).sum().backward()
    assert w.grad is not None and lk.linear_3xtf32.launches == before + 2


@pytest.mark.cuda
def test_linear_on_the_card_reads_rows_in_place_or_copies_them(cuda_device):
    """``layers.linear`` at every rank and layout the models hand it: a
    contiguous x of rank 3 or 4 is read in place, size-1 dims and all; a
    permuted or sliced one is copied first; each launches once, comes back
    in x's leading shape and matches the 2-D call on the same rows."""
    x, w, b = _operands(24, 16, 32, seed=8, device=cuda_device)
    wide = torch.zeros(24, 40, device=cuda_device)
    wide[:, :32] = x
    cases = {"rank 3": x.view(4, 6, 32), "rank 4": x.view(2, 2, 6, 32), "size-1 dims": x.view(1, 24, 1, 32),
             "permuted": x.view(6, 4, 32).transpose(0, 1), "sliced rows": wide[:, :32].view(4, 6, 32)}
    with torch.no_grad():
        for name, xs in cases.items():
            want = lk.linear_3xtf32(xs.reshape(-1, 32).contiguous(), w, b)
            before = lk.linear_3xtf32.launches
            y = layers.linear(xs, w, b)
            assert lk.linear_3xtf32.launches == before + 1, name
            assert y.shape == (*xs.shape[:-1], 16) and y.is_contiguous(), name
            assert torch.equal(y.reshape(-1, 16), want), name
            assert _scaled_err(y.reshape(-1, 16), xs.reshape(-1, 32), w, b) <= TOL, name


def _draw_dinov3(model: DINOv3, seed: int) -> None:
    """Every leaf drawn (scales 1 + 0.1·N, biases and tokens 0.02·N,
    LayerScale N, weights N/sqrt(fan-in)), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g, device="cuda")
            if p.ndim == 2 and name != "reg_tokens":
                p.copy_(z / math.sqrt(p.shape[1]))
            elif name.endswith((".ls1", ".ls2")):
                p.copy_(z)
            elif name.endswith(".scale"):
                p.copy_(1 + 0.1 * z)
            else:
                p.copy_(0.02 * z)


@pytest.fixture(scope="module")
def dinov3_full():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    model = DINOv3(DINOV3, device="cuda")
    _draw_dinov3(model, 7)
    return model


def _images(n, res, seed, device="cuda"):
    return torch.randn(n, res, res, 3, generator=torch.Generator().manual_seed(seed)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 12])
def test_launches_per_dinov3_forward(dinov3_full, batch):
    """32 blocks x (qkv, wo, wg, wu, wd) + the patch stem + the head."""
    before = lk.linear_3xtf32.launches
    with torch.inference_mode():
        dinov3_full(_images(batch, 224, batch))
    assert lk.linear_3xtf32.launches - before == 32 * 5 + 2 == 162


def _f_linear_logits(monkeypatch, model, images):
    with monkeypatch.context() as m:
        m.setattr(layers, "kernel_takes", lambda *a: False)
        before = lk.linear_3xtf32.launches
        with torch.inference_mode():
            out = model(images)
        assert lk.linear_3xtf32.launches == before
    return out


def _logits_within(monkeypatch, model, images, limit):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            got = model(images)
        want = _f_linear_logits(monkeypatch, model, images)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= limit, err


@pytest.mark.cuda
def test_dinov3_logits_against_f_linear(dinov3_full, monkeypatch):
    """Within cbo-r50-dinov3h's slow_logits limit (1e-4)."""
    _logits_within(monkeypatch, dinov3_full, _images(12, 224, 3), 1e-4)


@pytest.mark.cuda
def test_deitb_logits_against_f_linear(cuda_device, monkeypatch):
    """Within cbo-r50-deitb's slow_logits limit (1e-4)."""
    model = ViT(DEIT_B, generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    _logits_within(monkeypatch, model, _images(12, 224, 4), 1e-4)


@pytest.mark.cuda
def test_swinb_logits_against_f_linear(cuda_device, monkeypatch):
    """Within cbo-r50-swinb's slow_logits limit (5e-5); every
    zero-initialised leaf drawn, so biases and the relative-position
    table reach the logits."""
    model = Swin(SWIN_B, device="cuda", dtype=torch.float32)
    model.reset_parameters(torch.Generator(device="cuda").manual_seed(5), zero_std=0.02)
    _logits_within(monkeypatch, model, _images(8, 224, 5), 5e-5)


@pytest.mark.cuda
def test_dinov3_smoke_launches(cuda_device):
    """SMOKE's head (10 classes) is no multiple of 4: F.linear; its two
    blocks' five products and the stem launch the kernel."""
    model = DINOv3(DINOV3_SMOKE, device="cuda")
    _draw_dinov3(model, 8)
    before = lk.linear_3xtf32.launches
    with torch.inference_mode():
        model(_images(3, 32, 8))
    assert lk.linear_3xtf32.launches - before == 2 * 5 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bias", [((37, 64), True), ((37, 64), False), ((2, 5, 64), True)])
def test_linear_reports_on_the_card_what_meta_counts(cuda_device, shape, bias):
    """The dry run's counter: on the card ``linear`` launches the kernel
    once and reports ``cost.linear_cost``; on meta it is F.linear's one
    ``addmm``/``mm``, counted op by op to the same FLOPs and bytes."""
    from repro_torch.launch.roofline import CostCounter

    counts = {}
    for dev in ("cuda", "meta"):
        x, w = torch.ones(*shape, device=dev), torch.ones(48, 64, device=dev)
        b = torch.ones(48, device=dev) if bias else None
        before = lk.linear_3xtf32.launches
        with torch.no_grad(), CostCounter() as c:
            layers.linear(x, w, b)
        assert lk.linear_3xtf32.launches == before + (dev == "cuda")
        counts[dev] = (c.flops, c.bytes)
    assert counts["cuda"] == counts["meta"]
