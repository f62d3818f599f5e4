"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`; each test skips without CUDA. The file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from anatomix_tpu_torch.kernels.attention import (
    flash_attention,
    flash_attention_plain,
    qkv_prologue,
    qkv_prologue_plain,
)
from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_cat_ndhwc,
    conv3x3x3_cat_ndhwc_plain,
    conv3x3x3_ndhwc,
    conv3x3x3_ndhwc_plain,
    conv3x3x3_upcat_ndhwc,
    conv3x3x3_upcat_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.conv_down import (
    conv_down2_ndhwc,
    conv_down2_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.norm import (
    norm_apply_ndhwc,
    norm_apply_ndhwc_plain,
    norm_stats_ndhwc,
    norm_stats_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.reshuffle import (
    depth_to_space8_ndhwc,
    depth_to_space8_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.resize import (
    upsample2x_trilinear_ndhwc,
    upsample2x_trilinear_ndhwc_plain,
)
from anatomix_tpu_torch.kernels.scatter import (
    blend_scatter,
    blend_scatter_plain,
)
from anatomix_tpu_torch.ops.norms import _tile_sums, tile_maps, tile_sizes
from anatomix_tpu_torch.ops.sliding_window import gaussian_importance_axes


def _maxrel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "ci,co,pad,act,S",
    [(1, 16, "reflect", "relu", 32), (16, 16, "zeros", "lrelu", 24),
     (5, 7, "reflect", "elu", 10), (64, 64, "reflect", "tanh", 16)],
)
def test_conv_kernel_matches_plain(cuda, ci, co, pad, act, S):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, S, S + 2, S + 4, ci), generator=g,
                    device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda) * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    for out_dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        kw = dict(act=act, slope=0.3, pad_type=pad, out_dtype=out_dtype)
        got = conv3x3x3_ndhwc(x, w, b, **kw)
        ref = conv3x3x3_ndhwc_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("c1,c2,co,pad", [(16, 32, 16, "reflect"),
                                          (4, 6, 5, "zeros"),
                                          (0, 8, 8, "reflect")])
def test_upcat_kernel_matches_plain(cuda, c1, c2, co, pad):
    g = torch.Generator(device=cuda).manual_seed(1)
    small = torch.randn((2, 6, 5, 7, c2), generator=g, device=cuda).bfloat16()
    enc = None if c1 == 0 else torch.randn(
        (2, 12, 10, 14, c1), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * (c1 + c2), co), generator=g, device=cuda)
         * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    kw = dict(act="relu", pad_type=pad, out_dtype=torch.float32)
    got = conv3x3x3_upcat_ndhwc(enc, small, w, b, **kw)
    ref = conv3x3x3_upcat_ndhwc_plain(enc, small, w, b, **kw)
    torch.cuda.synchronize()
    assert _maxrel(got.cpu(), ref.cpu()) < 1e-4


@pytest.mark.gpu
def test_scatter_kernel_matches_plain(cuda):
    r, C = 16, 16
    axes, minv = gaussian_importance_axes((r, r, r), 0.25)
    gd, gh, gw = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                  for a in axes)
    starts = torch.tensor([[0, 0, 0], [5, 3, 7], [0, 0, 0]],
                          dtype=torch.int32, device=cuda)
    mask = torch.tensor([1, 1, 0], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    out = torch.randn((3, r, r, r, C), generator=g, device=cuda)
    canvas = torch.randn((24, 20, 28, C), generator=g, device=cuda)
    got = blend_scatter(canvas.clone(), out, starts, mask, gd, gh, gw, minv)
    ref = blend_scatter_plain(canvas.clone(), out, starts, mask, gd, gh, gw,
                              minv)
    torch.cuda.synchronize()
    assert _maxrel(got.cpu(), ref.cpu()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("c1,c2,co,pad,S", [(32, 64, 32, "reflect", 12),
                                            (16, 8, 5, "zeros", 9),
                                            (4, 6, 8, "reflect", 6),
                                            (64, 128, 64, "reflect", 4)])
def test_cat_kernel_matches_plain(cuda, c1, c2, co, pad, S):
    """The two-operand conv at one resolution, down to the dev bottleneck's
    4^3 (smaller than the kernel's 16x4x2 output brick)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    enc = torch.randn((2, S, S + 1, S + 2, c1), generator=g,
                      device=cuda).bfloat16()
    up = torch.randn((2, S, S + 1, S + 2, c2), generator=g,
                     device=cuda).bfloat16()
    w = (torch.randn((27 * (c1 + c2), co), generator=g, device=cuda)
         * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    for out_dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        kw = dict(act="none", pad_type=pad, out_dtype=out_dtype)
        got = conv3x3x3_cat_ndhwc(enc, up, w, b, **kw)
        ref = conv3x3x3_cat_ndhwc_plain(enc, up, w, b, **kw)
        torch.cuda.synchronize()
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("shape,tiles,act,dtype", [
    ((2, 8, 8, 8, 32), (1, 1, 1), "relu", torch.bfloat16),
    ((2, 8, 8, 8, 32), (1, 1, 1), "relu", torch.float32),
    ((1, 16, 12, 20, 32), (2, 2, 2), "lrelu", torch.float32),
    ((1, 40, 40, 40, 32), (3, 3, 3), "relu", torch.float32),
    ((2, 6, 5, 7, 12), (2, 1, 3), "none", torch.bfloat16),  # C % 8 != 0
    ((2, 6, 5, 7, 12), (2, 1, 3), "elu", torch.float32),
])
def test_norm_apply_kernel_matches_plain(cuda, shape, tiles, act, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    ts = (shape[0],) + tiles + (shape[-1],)
    a = torch.rand(ts, generator=g, device=cuda) + 0.5
    s = torch.randn(ts, generator=g, device=cuda)
    maps = tile_maps(shape[1:4], tiles, cuda)
    got = norm_apply_ndhwc(x, a, s, maps, act=act, slope=0.3)
    ref = norm_apply_ndhwc_plain(x, a, s, maps, act=act, slope=0.3)
    torch.cuda.synchronize()
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2


def _norm_stats_f64(x, tiles, eps, scale, bias):
    """(a, s) of `norm_stats_ndhwc` in float64."""
    sizes = tile_sizes(x.shape[1:4], tiles)
    x64 = x.double()
    counts = torch.tensor([float(d * h * w) for d in sizes[0]
                           for h in sizes[1] for w in sizes[2]],
                          dtype=torch.float64, device=x.device)
    counts = counts.reshape(1, *map(len, sizes), 1)
    mean = _tile_sums(x64, sizes) / counts
    var = (_tile_sums(x64.square(), sizes) / counts - mean.square()).clamp(
        min=0.0)
    a = torch.rsqrt(var + eps)
    if scale is not None:
        a = a * scale.double()
    s = -mean * a
    if bias is not None:
        s = s + bias.double()
    return a, s


@pytest.mark.gpu
@pytest.mark.parametrize("shape,tiles,dtype,affine", [
    ((2, 128, 128, 128, 32), (1, 1, 1), torch.float32, False),  # dev level 1
    ((2, 4, 4, 4, 1024), (1, 1, 1), torch.float32, True),  # its bottleneck
    ((1, 88, 64, 40, 32), (3, 2, 3), torch.float32, True),  # uneven tiles
    ((2, 64, 64, 64, 64), (1, 1, 1), torch.bfloat16, True),
    ((2, 6, 5, 7, 12), (2, 1, 3), torch.float32, False),  # C % 4 != 0
    ((2, 6, 5, 7, 12), (2, 1, 3), torch.bfloat16, False),
])
def test_norm_stats_kernel_matches_plain(cuda, shape, tiles, dtype, affine):
    """The statistics kernel against its plain version and a float64
    witness (a conv output's spread: a channel's mean up to ~3 std), and
    two launches on one input equal bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(21)
    C = shape[-1]
    x = (torch.randn(shape, generator=g, device=cuda)
         + torch.randn((C,), generator=g, device=cuda)).to(dtype)
    scale = bias = None
    if affine:
        scale = torch.rand((C,), generator=g, device=cuda) + 0.5
        bias = torch.randn((C,), generator=g, device=cuda)
    kw = dict(eps=1e-2, scale=scale, bias=bias)
    before = norm_stats_ndhwc.launches
    got = norm_stats_ndhwc(x, tiles, **kw)
    again = norm_stats_ndhwc(x, tiles, **kw)
    plain = norm_stats_ndhwc_plain(x, tiles, **kw)
    witness = _norm_stats_f64(x, tiles, **kw)
    torch.cuda.synchronize()
    assert norm_stats_ndhwc.launches == before + 2
    for k, a, p, w in zip(got, again, plain, witness):
        assert k.dtype == torch.float32 and k.shape == p.shape
        assert torch.equal(k, a)
        assert _maxrel(k.cpu(), w.cpu()) < 1e-5
        assert _maxrel(k.cpu(), p.cpu()) < 1e-4


@pytest.mark.gpu
def test_norm_stats_kernel_runs_once_a_live_norm(cuda):
    """One dev fused forward takes the statistics kernel once for each of
    its 23 live instance norms; the 6M forward (batch norms folded) never."""
    from anatomix_tpu_torch.extract import make_feature_extractor
    from anatomix_tpu_torch.models.load import load_model
    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        init_params,
    )

    plan = build_plan(UnetConfig(
        **ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"]))
    sd = {k: v.to(cuda) for k, v in init_params(
        plan, torch.Generator().manual_seed(0)).items()}
    x = torch.rand((1, 64, 64, 64, 1), device=cuda)
    dev_fwd = make_feature_extractor(plan, sd, strategy="full", device=cuda)
    n = (norm_stats_ndhwc.launches, norm_apply_ndhwc.launches)
    y = dev_fwd(x)
    torch.cuda.synchronize()
    assert y.shape == (1, 64, 64, 64, 32) and bool(torch.isfinite(y).all())
    assert norm_stats_ndhwc.launches == n[0] + 23
    assert norm_apply_ndhwc.launches == n[1] + 23
    plan6, sd6 = load_model("scratch", allow_scratch=True, device=cuda)
    n = norm_stats_ndhwc.launches
    make_feature_extractor(plan6, sd6, strategy="full", device=cuda)(x)
    torch.cuda.synchronize()
    assert norm_stats_ndhwc.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 4, 5, 6, 16), (1, 3, 3, 3, 12),
                                   (1, 1, 2, 3, 8)])
def test_upsample_kernel_matches_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda).bfloat16()
    got = upsample2x_trilinear_ndhwc(x)
    ref = upsample2x_trilinear_ndhwc_plain(x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape,ci,co", [
    (2, (16, 16, 16), 32, 64),   # the tokenizer's first stage, cut down
    (1, (9, 10, 7), 16, 32),     # odd extents: the zero row past the end
    (2, (8, 6, 12), 12, 20),     # Ci, Co not multiples of 8 or 16
    (1, (4, 4, 4), 128, 256),    # the last stage's widths
])
def test_conv_down_kernel_matches_plain(cuda, B, shape, ci, co):
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((B,) + shape + (ci,), generator=g,
                    device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    for out_dtype, act, tol in ((torch.float32, "none", 1e-4),
                                (torch.bfloat16, "lrelu", 1e-2)):
        kw = dict(act=act, slope=0.01, out_dtype=out_dtype)
        got = conv_down2_ndhwc(x, w, b, **kw)
        ref = conv_down2_ndhwc_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (B,) + tuple(
            (n - 1) // 2 + 1 for n in shape) + (co,)
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("B,shape,ci,co,kind", [
    (2, (128, 128, 128), 3 * 32, 64, "brick"),  # the tokenizer's stages on
    (2, (64, 64, 64), 3 * 64, 128, "ring"),     # the three-term split
    (2, (32, 32, 32), 3 * 128, 256, "split"),
    (1, (15, 16, 17), 12, 20, "ring"),   # odd extents; Ci % 16, Co % 8 != 0
    (2, (63, 64, 65), 12, 20, "brick"),  # the same on the parity-split brick
])
def test_conv_down_plans_match_plain(cuda, B, shape, ci, co, kind):
    """V2 on each plan `conv_plan(..., mode=MODE_S2)` picks (the
    parity-split halo brick, the gather ring, split K) against its plain
    version: f32 out within k 2^-24 of max |ref| for a k-product reduction
    (at least 1e-4), bf16 out within 1e-2; where K is split, two launches
    give the same bits."""
    from anatomix_tpu_torch.kernels.conv import MODE_S2, conv_plan
    from anatomix_tpu_torch.kernels.conv_train import s2_grid

    plan = conv_plan(B, s2_grid(shape), ci, co, mode=MODE_S2)
    assert kind == ("brick" if plan.brick else
                    "split" if plan.splits > 1 else "ring")
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((B,) + shape + (ci,), generator=g,
                    device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * (2.0 / (27 * ci)) ** 0.5).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda) * 0.1
    n = conv_down2_ndhwc.launches
    for out_dtype, act, tol in (
            (torch.float32, "none", max(1e-4, 27 * ci * 2.0 ** -24)),
            (torch.bfloat16, "lrelu", 1e-2)):
        kw = dict(act=act, slope=0.01, out_dtype=out_dtype)
        got = conv_down2_ndhwc(x, w, b, **kw)
        again = conv_down2_ndhwc(x, w, b, **kw)
        ref = conv_down2_ndhwc_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (B, *s2_grid(shape), co)
        assert got.dtype == out_dtype
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol
        if plan.splits > 1:
            assert torch.equal(got, again)
        del got, again, ref
    assert conv_down2_ndhwc.launches == n + 4


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd", [
    (1, 6, 4104, 66),   # the ViT's window at B=1: a ragged key tail
    (2, 2, 129, 66),    # one key past a tile
    (1, 3, 50, 32),     # fewer keys than one tile
    (2, 1, 200, 128),
    # ragged at the kernel's tiles (64 keys, 192 queries a block up to
    # hd 80, 128 at hd 128): one key, one short of and one past a key
    # tile, around a query block
    (1, 2, 1, 66), (2, 2, 127, 16), (1, 3, 129, 80), (2, 1, 191, 66),
    (1, 2, 193, 128), (1, 2, 127, 128), (2, 6, 4104, 80),
    (1, 2, 4104, 16), (1, 2, 4104, 128),
])
def test_flash_attention_kernel_matches_plain(cuda, B, H, N, hd):
    """The forward against its plain version within the bf16 bound 1e-2
    (max |err| / max |ref|); a second launch gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((B, H, N, hd), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    scale = hd ** -0.5
    got = flash_attention(q, k, v, scale)
    again = flash_attention(q, k, v, scale)
    ref = flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,heads,hd,R,qk_norm,rope", [
    (2, 4104, 6, 66, 8, True, True),     # the ViT cell's call
    (2, 4096, 6, 72, 0, False, True),    # hd 72, no registers, no qk-norm
    (1, 77, 2, 12, 3, True, False),      # rows past the last full block
    (1, 9, 1, 128, 9, True, True),       # the widest hd; registers only
])
def test_qkv_prologue_kernel_matches_plain(cuda, B, N, heads, hd, R,
                                           qk_norm, rope):
    """The prologue kernel against its plain version (torch's LayerNorm
    and the rotation on the card): v bit for bit; q and k within one bf16
    ulp elementwise, differing on under 0.1 % of the elements (the f32 sums
    in another order flip a rounding now and then); a second launch gives
    the same bits. An ulp of a value that the rotation's difference leaves
    near zero is far under the f32 rounding of its O(1) terms, so each
    element may also differ by four f32 ulps of the largest value."""
    g = torch.Generator(device=cuda).manual_seed(23)
    D = heads * hd
    q, k, v = (torch.randn((B, N, D), generator=g, device=cuda) * 1.5
               + torch.randn((D,), generator=g, device=cuda) * 0.5
               for _ in range(3))
    kw = dict(registers=R)
    if qk_norm:
        kw["q_norm"], kw["k_norm"] = (
            (1 + 0.1 * torch.randn((hd,), generator=g, device=cuda),
             0.05 * torch.randn((hd,), generator=g, device=cuda))
            for _ in range(2))
    if rope:
        angles = torch.rand((N - R, hd // 2), generator=g,
                            device=cuda) * 6.3 - 3.15
        kw["rope"] = (torch.cos(angles), torch.sin(angles))
    n = qkv_prologue.launches
    got = qkv_prologue(q, k, v, heads, **kw)
    again = qkv_prologue(q, k, v, heads, **kw)
    ref = qkv_prologue_plain(q, k, v, heads, **kw)
    torch.cuda.synchronize()
    assert qkv_prologue.launches == n + 2
    for a, b, r in zip(got, again, ref):
        assert a.shape == (B, heads, N, hd) and a.dtype == torch.bfloat16
        assert a.is_contiguous() and torch.equal(a, b)
    assert torch.equal(got[2], ref[2])
    for a, r in zip(got[:2], ref[:2]):
        a, r = a.float(), r.float()
        big = torch.maximum(a.abs(), r.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        f32 = 2.0 ** -22 * float(r.abs().max())
        assert bool(((a - r).abs() <= ulp + f32).all())
        assert float((a != r).float().mean()) < 1e-3


@pytest.mark.gpu
def test_qkv_prologue_runs_once_a_vit_block(cuda):
    """One `anatomix-dev-vit` forward takes the prologue kernel once a
    block (12); a dev UNet forward and a ViT pretraining step (whose
    differentiable prologue stays in torch) never."""
    from anatomix_tpu_torch.extract import make_feature_extractor
    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        init_params,
    )
    from anatomix_tpu_torch.models.vit3d import (
        Primus,
        PrimusConfig,
        init_primus_params,
        primus_config,
    )
    from anatomix_tpu_torch.pretraining import train_step as ts

    cfg = primus_config(ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"])
    model = Primus.from_state_dict(
        cfg, init_primus_params(cfg, torch.Generator().manual_seed(0)),
        device=cuda)
    n = qkv_prologue.launches
    y = model(torch.rand((1, *cfg.input_shape, 1), device=cuda))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert qkv_prologue.launches == n + cfg.eva_depth == n + 12

    plan = build_plan(UnetConfig(
        **ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"]))
    sd = {k: v.to(cuda) for k, v in init_params(
        plan, torch.Generator().manual_seed(0)).items()}
    n = qkv_prologue.launches
    make_feature_extractor(plan, sd, strategy="full", device=cuda)(
        torch.rand((1, 64, 64, 64, 1), device=cuda))
    torch.cuda.synchronize()
    assert qkv_prologue.launches == n

    small = PrimusConfig(num_classes=8, embed_dim=64, eva_depth=2,
                         eva_numheads=2, input_shape=(32, 32, 32),
                         num_register_tokens=2, qk_norm=True,
                         out_norm="demean", scale_attn_inner=True,
                         tokenizer_base_features=8)
    state = ts.init_train_state(small, torch.Generator().manual_seed(0),
                                tap_layers=(-1,), netf_nc=32, device=cuda)
    rng = np.random.default_rng(0)
    views = torch.from_numpy(rng.standard_normal(
        (1, 2, 32, 32, 32, 1)).astype(np.float32)).to(cuda)
    segs = torch.from_numpy(rng.integers(0, 5, (1, 32, 32, 32, 1))).to(cuda)
    step = ts.build_train_step(small, tap_layers=(-1,), num_patches=256)
    n = qkv_prologue.launches
    state, metrics = step(state, views, segs,
                          torch.Generator(device=cuda).manual_seed(3))
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert qkv_prologue.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("B,dhw,C,with_sub", [
    (2, (2, 2, 2), 32, True), (1, (1, 3, 2), 32, False),
    (1, (2, 1, 1), 4, True), (2, (1, 1, 2), 6, True),  # C % 4 != 0
])
def test_depth_to_space8_kernel_matches_plain(cuda, B, dhw, C, with_sub):
    g = torch.Generator(device=cuda).manual_seed(8)
    y = torch.randn((B,) + dhw + (512 * C,), generator=g,
                    device=cuda).bfloat16()
    sub = (torch.randn((B, 512 * C), generator=g, device=cuda)
           if with_sub else None)
    got = depth_to_space8_ndhwc(y, sub)
    ref = depth_to_space8_ndhwc_plain(y, sub)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got.cpu(), ref.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((2, 8, 8, 8, 64), torch.float32),    # the tokenizer: f32 conv store
    ((1, 5, 6, 7, 12), torch.bfloat16),   # C % 8 != 0
])
def test_norm_apply_residual_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    r = torch.randn(shape, generator=g, device=cuda).bfloat16()
    ts = (shape[0], 1, 1, 1, shape[-1])
    a = torch.rand(ts, generator=g, device=cuda) + 0.5
    s = torch.randn(ts, generator=g, device=cuda)
    maps = tile_maps(shape[1:4], (1, 1, 1), cuda)
    kw = dict(act="lrelu", slope=0.01, residual=r)
    got = norm_apply_ndhwc(x, a, s, maps, **kw)
    ref = norm_apply_ndhwc_plain(x, a, s, maps, **kw)
    torch.cuda.synchronize()
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ci,co,pad", [
    ((2, 16, 16, 16), 16, 16, "reflect"),
    ((2, 8, 8, 8), 48, 16, "reflect"),
    ((1, 5, 7, 18), 12, 40, "zeros"),   # ragged tiles, Ci % 8 != 0
    ((2, 10, 6, 9), 1, 16, "reflect"),  # the entry conv (wgrad only)
])
def test_conv_backward_kernels_match_plain(cuda, shape, ci, co, pad):
    from anatomix_tpu_torch.kernels.conv_train import (
        conv3x3x3_dgrad_ndhwc,
        conv3x3x3_dgrad_ndhwc_plain,
        conv3x3x3_wgrad_ndhwc,
        conv3x3x3_wgrad_ndhwc_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((*shape, ci), generator=g, device=cuda).bfloat16()
    dy = torch.randn((*shape, co), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * 0.1).bfloat16()
    dw = conv3x3x3_wgrad_ndhwc(x, dy, pad_type=pad)
    ref = conv3x3x3_wgrad_ndhwc_plain(x, dy, pad_type=pad)
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32 and dw.shape == ref.shape
    assert _maxrel(dw.cpu(), ref.cpu()) < 1e-3
    if ci > 1:
        dx = conv3x3x3_dgrad_ndhwc(dy, w, pad_type=pad)
        ref = conv3x3x3_dgrad_ndhwc_plain(dy, w, pad_type=pad)
        torch.cuda.synchronize()
        assert dx.dtype == torch.bfloat16 and dx.shape == x.shape
        assert _maxrel(dx.float().cpu(), ref.float().cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("S,c1,c2,co,out_dtype", [
    (4, 3 * 1024, 0, 1024, torch.float32),      # the dev bottleneck (split)
    (8, 3 * 512, 0, 512, torch.float32),        # the dev 8^3 level
    (8, 3 * 512, 3 * 1024, 512, torch.bfloat16),  # its D3 decoder (cat)
])
def test_split_k_convs_match_plain_and_repeat_bit_for_bit(cuda, S, c1, c2,
                                                          co, out_dtype):
    """The deep convs whose K the plan splits over the card (f32 partials,
    summed in a fixed order by a second kernel) against their plain
    versions (bf16 out 1e-2; f32 out k 2^-24 for a k-product reduction),
    and two launches giving the same bits."""
    from anatomix_tpu_torch.kernels.conv import conv_plan

    g = torch.Generator(device=cuda).manual_seed(5)
    ci = c1 + c2
    x = torch.randn((2, S, S, S, c1), generator=g, device=cuda).bfloat16()
    up = (torch.randn((2, S, S, S, c2), generator=g, device=cuda).bfloat16()
          if c2 else None)
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * (2.0 / (27 * ci)) ** 0.5).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda) * 0.1
    plan = conv_plan(2, (S, S, S), ci, co)
    assert plan.splits > 1
    assert plan.m_tiles * plan.n_tiles * plan.splits >= 132
    kw = dict(act="none", pad_type="reflect", out_dtype=out_dtype)
    if up is None:
        run = lambda: conv3x3x3_ndhwc(x, w, b, **kw)  # noqa: E731
        ref = conv3x3x3_ndhwc_plain(x, w, b, **kw)
    else:
        run = lambda: conv3x3x3_cat_ndhwc(x, up, w, b, **kw)  # noqa: E731
        ref = conv3x3x3_cat_ndhwc_plain(x, up, w, b, **kw)
    got, again = run(), run()
    torch.cuda.synchronize()
    tol = (1e-2 if out_dtype == torch.bfloat16
           else max(1e-4, 27 * ci * 2.0 ** -24))
    assert got.dtype == out_dtype
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ci,co", [
    ((1, 15, 16, 17), 8, 16),   # odd extents
    ((2, 9, 7, 11), 32, 64),    # the first tokenizer stage's widths
    ((1, 7, 9, 5), 96, 32),     # wide dx: the gather kernel's classes
    ((1, 6, 10, 13), 5, 12),    # widths that are not a multiple of 8
])
def test_stride2_gradient_kernels_match_plain(cuda, shape, ci, co):
    """The stride-2 modes of T-w and T-x, which read dy on its own grid,
    against their plain versions (dW 1e-3, dx 1e-2) and against the plain
    zero-inserted route."""
    from anatomix_tpu_torch.kernels import conv_down as kd
    from anatomix_tpu_torch.kernels import conv_train as kt

    g = torch.Generator(device=cuda).manual_seed(6)
    spatial = shape[1:4]
    x = torch.randn((*shape, ci), generator=g, device=cuda).bfloat16()
    dy = torch.randn((shape[0], *kt.s2_grid(spatial), co), generator=g,
                     device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * 0.1).bfloat16()
    n = (kt.conv3x3x3_wgrad_ndhwc.launches, kt.conv3x3x3_dgrad_ndhwc.launches)
    dw = kt.conv3x3x3_wgrad_ndhwc(x, dy, pad_type="zeros", stride=2)
    dx = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type="zeros", stride=2,
                                  spatial=spatial)
    torch.cuda.synchronize()
    assert (kt.conv3x3x3_wgrad_ndhwc.launches,
            kt.conv3x3x3_dgrad_ndhwc.launches) == (n[0] + 1, n[1] + 1)
    assert dw.dtype == torch.float32 and dx.dtype == torch.bfloat16
    assert dx.shape == x.shape
    rdw = kt.conv3x3x3_wgrad_s2_ndhwc_plain(x, dy)
    rdx = kt.conv3x3x3_dgrad_s2_ndhwc_plain(dy, w, spatial)
    assert _maxrel(dw.cpu(), rdw.cpu()) < 1e-3
    assert _maxrel(dx.float().cpu(), rdx.float().cpu()) < 1e-2
    zdx, zdw = kd.conv_down2_backward_plain(x, dy, w)
    assert _maxrel(dw.cpu(), zdw.cpu()) < 1e-3
    assert _maxrel(dx.float().cpu(), zdx.float().cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("which,shape,dtype", [
    ("s2d", (2, 16, 8, 12, 16), torch.bfloat16),
    ("s2d", (1, 4, 6, 2, 3), torch.bfloat16),   # 6-byte runs: 2-byte units
    ("s2d", (1, 6, 4, 8, 5), torch.float32),
    ("d2s", (2, 8, 4, 6, 8 * 32), torch.bfloat16),
    ("d2s", (1, 3, 2, 5, 8 * 3), torch.bfloat16),
    ("d2s", (1, 2, 3, 4, 8 * 6), torch.float32),
    ("d2s", (2, 4, 3, 2, 8 * 99), torch.bfloat16),  # the ViT decoder's 99
    ("d2s", (1, 2, 2, 4, 8 * 49), torch.bfloat16),
    ("s2d", (1, 8, 4, 6, 8), torch.float32),  # the v1 tokenizer chain
])
def test_reshuffle2_kernels_match_plain(cuda, which, shape, dtype):
    from anatomix_tpu_torch.kernels import reshuffle as kr

    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    fn, plain = ((kr.space_to_depth2_ndhwc, kr.space_to_depth2_ndhwc_plain)
                 if which == "s2d" else
                 (kr.depth_to_space2_ndhwc, kr.depth_to_space2_ndhwc_plain))
    n = fn.launches
    got = fn(x)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert torch.equal(got.cpu(), plain(x).cpu())
    # each is the other's inverse
    back = (kr.depth_to_space2_ndhwc if which == "s2d"
            else kr.space_to_depth2_ndhwc)(got)
    assert torch.equal(back.cpu(), x.cpu())


@pytest.mark.gpu
def test_pretrain_step_kernels_match_plain_path(cuda):
    """One loss-and-gradient evaluation of the pretraining step (a small
    6M-family UNet at 32^3) on the kernels (bf16): the loss against the
    plain f32 path (F.conv3d under autograd) within 1e-2; every conv
    backward launch against its plain version on the same tensors; every
    conv's dW (mean |err| / std) within 5e-2 of the plain conv backward from
    the same forward. (End to end, the step's dW at initialization moves by
    tens of percent under a bf16-size change of its input, the plain
    path's too, so it is no test of the kernels.) Then one step runs, with
    each kernel of the path launched as often as the walk needs."""
    from anatomix_tpu_torch.kernels import conv_train as kt
    from anatomix_tpu_torch.kernels import reshuffle as kr
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all
    from anatomix_tpu_torch.pretraining.train_step import (
        NCEOptions,
        nce_loss_and_grads,
    )

    cfg = PretrainConfig(ngf=8, num_downs=2, nce_layers=(17, 20, 24, 31, 37),
                         netF_nc=32, num_patches=128)
    plan, taps, state, step = build_all(cfg, 1, device="cuda")
    rng = np.random.default_rng(0)
    views = torch.from_numpy(rng.standard_normal(
        (1, 2, 32, 32, 32, 1)).astype(np.float32)).to(cuda)
    segs = torch.from_numpy(rng.integers(0, 5, (1, 32, 32, 32, 1))).to(cuda)
    kw = dict(tap_layers=taps, num_patches=128, nce=NCEOptions())

    def run(**extra):
        return nce_loss_and_grads(
            plan, state.params_g, state.params_f, views, segs,
            torch.Generator(device=cuda).manual_seed(3), **kw, **extra)

    calls = []

    def rec(fn, plain):
        def call(a, b, *, pad_type):
            out = fn(a, b, pad_type=pad_type)
            calls.append((out, plain(a, b, pad_type=pad_type)))
            return out
        return call

    wgrad, dgrad = kt.conv3x3x3_wgrad_ndhwc, kt.conv3x3x3_dgrad_ndhwc
    n_conv = len(plan.conv_indices)
    before = (wgrad.launches, dgrad.launches)
    with kt.backward_route(rec(dgrad, kt.conv3x3x3_dgrad_ndhwc_plain),
                           rec(wgrad, kt.conv3x3x3_wgrad_ndhwc_plain)):
        loss, _, grads, _ = run()
    assert (wgrad.launches - before[0], dgrad.launches - before[1]) == (
        n_conv, n_conv - 1)
    assert len(calls) == 2 * n_conv - 1
    for got, ref in calls:
        tol = 1e-3 if got.dtype == torch.float32 else 1e-2
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol
    before = (wgrad.launches, dgrad.launches)
    with kt.backward_route(kt.conv3x3x3_dgrad_ndhwc_plain,
                           kt.conv3x3x3_wgrad_ndhwc_plain):
        same_fwd, _, ref_grads, _ = run()
    assert (wgrad.launches, dgrad.launches) == before
    assert abs(float(same_fwd) - float(loss)) <= 1e-6 * abs(float(loss))
    for i in plan.conv_indices:
        got, ref = grads[f"model.{i}.weight"], ref_grads[f"model.{i}.weight"]
        assert float((got - ref).abs().mean() / ref.std()) < 5e-2, i
    ref, _, _, _ = run(plain=True)
    assert abs(float(loss) - float(ref)) < 1e-2 * abs(float(ref))
    wrappers = (wgrad, dgrad, kt.pad_shell_ndhwc,
                kr.space_to_depth2_ndhwc, kr.depth_to_space2_ndhwc)
    before = [fn.launches for fn in wrappers]
    state, metrics = step(state, views, segs,
                          torch.Generator(device=cuda).manual_seed(3))
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    # each reflect dx a split store and a shell pass; each pool and upsample
    # permutes forward and backward
    n_resize = sum(spec.kind in ("pool", "upsample") for spec in plan.layers)
    assert [fn.launches - n for fn, n in zip(wrappers, before)] == [
        n_conv, n_conv - 1, n_conv - 1, n_resize, n_resize]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N,hd", [
    (2, 6, 4104, 66),   # the ViT step's shape: a ragged tail
    (1, 2, 130, 66),    # two keys past a tile, 2 queries past a dkv tile
    (2, 1, 50, 16),     # fewer rows than one tile
    (1, 3, 97, 80),
    # ragged at dq's tiles (64 keys, 192 queries a block)
    (1, 2, 1, 66), (2, 1, 127, 80), (1, 2, 129, 16), (1, 2, 191, 66),
    (2, 1, 193, 32),
])
def test_flash_attention_backward_kernels_match_plain(cuda, B, H, N, hd):
    """The forward's log-sum-exp, dkv and dq against their plain versions
    on the same bf16 inputs, within the bf16-operand bound 1e-2 (max |err|
    / max |ref|); the forward's output is unchanged by asking for the
    lse; a second dkv and a second dq launch give the same bits."""
    from anatomix_tpu_torch.kernels import attention as ka

    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do = (torch.randn((B, H, N, hd), generator=g,
                               device=cuda).bfloat16() for _ in range(4))
    scale = hd ** -0.5
    o, lse = ka.flash_attention(q, k, v, scale, return_lse=True)
    assert torch.equal(o, ka.flash_attention(q, k, v, scale))
    ref_o, ref_lse = ka.flash_attention_lse_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, N) and lse.dtype == torch.float32
    assert float((lse - ref_lse).abs().max()) < 1e-3
    di = ka.attention_di(o, do)
    n = (ka.flash_attention_bwd_dkv.launches,
         ka.flash_attention_bwd_dq.launches)
    dk, dv = ka.flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
    dq = ka.flash_attention_bwd_dq(q, k, v, lse, do, di, scale)
    torch.cuda.synchronize()
    assert (ka.flash_attention_bwd_dkv.launches,
            ka.flash_attention_bwd_dq.launches) == (n[0] + 1, n[1] + 1)
    dk2, dv2 = ka.flash_attention_bwd_dkv(q, k, v, lse, do, di, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, ka.flash_attention_bwd_dq(q, k, v, lse, do, di,
                                                     scale))
    rk, rv = ka.flash_attention_bwd_dkv_plain(q, k, v, lse, do, di, scale)
    rq = ka.flash_attention_bwd_dq_plain(q, k, v, lse, do, di, scale)
    # with one key P = 1 and o = v, so dS = dO v^T - di is zero but for the
    # f32 rounding of two hd-term sums that cancel: dq and dk are held to
    # that rounding (4 hd ulps of sum |dO v|) times |k| or |q| and the scale
    terms = float((do.float() * v.float()).abs().sum(-1).max())
    for got, ref, other in ((dq, rq, k), (dk, rk, q), (dv, rv, None)):
        assert got.dtype == torch.float32 and got.shape == q.shape
        assert torch.isfinite(got).all()
        if N == 1 and other is not None:
            bound = (4 * hd * 2.0 ** -24 * terms
                     * float(other.float().abs().max()) * scale)
            assert float(got.abs().max()) <= bound
        else:
            assert _maxrel(got.cpu(), ref.cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ci,co", [
    ((2, 16, 16, 16), 8, 16),
    ((1, 10, 6, 12), 32, 64),   # ragged tiles
])
def test_conv_down_backward_on_kernels_matches_plain(cuda, shape, ci, co):
    """The stride-2 conv's dx and dW through `conv_down2_train`'s backward
    (T-x and T-w in their stride-2 mode) against the zero-inserted route on
    the plain stride-1 gradient functions."""
    from anatomix_tpu_torch.kernels import conv_down as kd

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((*shape, ci), generator=g, device=cuda)
    w = torch.randn((co, ci, 3, 3, 3), generator=g, device=cuda) * 0.1
    b = torch.randn((co,), generator=g, device=cuda)
    xb = x.bfloat16().requires_grad_()
    wl = w.clone().requires_grad_()
    y = kd.conv_down2_train(xb, wl, b)
    dy = torch.randn(y.shape, generator=g, device=cuda)
    dx, dw = torch.autograd.grad(y, (xb, wl), dy)
    rdx, rdw = kd.conv_down2_backward_plain(
        xb.detach(), dy.bfloat16(), kd.pack_conv_weight(w).bfloat16())
    torch.cuda.synchronize()
    assert _maxrel(dx.float().cpu(), rdx.float().cpu()) < 1e-2
    assert _maxrel(dw.cpu(), kd.unpack_conv_weight(rdw, ci).cpu()) < 1e-3


@pytest.mark.gpu
def test_vit_pretrain_step_kernels_match_plain_path(cuda):
    """One loss-and-gradient evaluation of the ViT pretraining step (a
    small Primus at 32^3: embed 64, 2 blocks, 2 heads of 32) on the kernels
    against the plain f32 path (loss within 1e-2), every dkv and dq launch
    against its plain version on the same tensors (1e-2), and every
    gradient of q, k and v through the whole backward against the plain
    attention backward from the same forward (mean |err| / std < 5e-2);
    then one step, with dkv and dq launched once per block."""
    from anatomix_tpu_torch.kernels import attention as ka
    from anatomix_tpu_torch.models.vit3d import PrimusConfig
    from anatomix_tpu_torch.pretraining import train_step as ts

    cfg = PrimusConfig(num_classes=8, embed_dim=64, eva_depth=2,
                       eva_numheads=2, input_shape=(32, 32, 32),
                       num_register_tokens=2, qk_norm=True,
                       out_norm="demean", scale_attn_inner=True,
                       tokenizer_base_features=8)
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                tap_layers=(-1,), netf_nc=32, device=cuda)
    rng = np.random.default_rng(0)
    views = torch.from_numpy(rng.standard_normal(
        (1, 2, 32, 32, 32, 1)).astype(np.float32)).to(cuda)
    segs = torch.from_numpy(rng.integers(0, 5, (1, 32, 32, 32, 1))).to(cuda)
    kw = dict(tap_layers=(-1,), num_patches=256, nce=ts.NCEOptions())

    def run(**extra):
        return ts.nce_loss_and_grads(
            cfg, state.params_g, state.params_f, views, segs,
            torch.Generator(device=cuda).manual_seed(3), **kw, **extra)

    calls, plain_calls = [], []

    def rec(fn, plain, out):
        def call(*args):
            got = fn(*args)
            out.append((got, plain(*args)) if plain else got)
            return got
        return call

    with ka.backward_route(
            rec(ka.flash_attention_bwd_dkv, ka.flash_attention_bwd_dkv_plain,
                calls),
            rec(ka.flash_attention_bwd_dq, ka.flash_attention_bwd_dq_plain,
                calls)):
        loss, _, _, _ = run()
    assert len(calls) == 2 * cfg.eva_depth
    for got, ref in calls:
        for a, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert _maxrel(a.cpu(), r.cpu()) < 1e-2
    with ka.backward_route(
            rec(ka.flash_attention_bwd_dkv_plain, None, plain_calls),
            rec(ka.flash_attention_bwd_dq_plain, None, plain_calls)):
        same, _, _, _ = run()
    assert abs(float(same) - float(loss)) <= 1e-6 * abs(float(loss))
    # each attention's (dk, dv) and dq, the whole backward on the kernels
    # against the whole backward on the plain versions
    for (got, _), ref in zip(calls, plain_calls):
        for a, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert float((a - r).abs().mean() / r.std()) < 5e-2
    ref, _, _, _ = run(plain=True)
    assert abs(float(loss) - float(ref)) < 1e-2 * abs(float(ref))
    n = (ka.flash_attention_bwd_dkv.launches,
         ka.flash_attention_bwd_dq.launches)
    step = ts.build_train_step(cfg, tap_layers=(-1,), num_patches=256)
    state, metrics = step(state, views, segs,
                          torch.Generator(device=cuda).manual_seed(3))
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert (ka.flash_attention_bwd_dkv.launches - n[0],
            ka.flash_attention_bwd_dq.launches - n[1]) == (
        cfg.eva_depth, cfg.eva_depth)


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["fold", "interleave"])
@pytest.mark.parametrize("shape,C", [((2, 4, 6, 8), 32), ((1, 2, 3, 4), 99),
                                     ((1, 4, 2, 16), 8)])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float32)])
@pytest.mark.parametrize("with_sub", [True, False])
def test_d2s_exit_kernels_match_plain(cuda, which, shape, C, in_dtype,
                                      out_dtype, with_sub):
    """The fold and interleave exits: exact against their plain versions
    (the same f32 subtract, one rounding), each launch counted."""
    from anatomix_tpu_torch.kernels import reshuffle as kr

    if which == "fold" and not kr.fold_supported(C, shape[3]):
        pytest.skip("outside the fold envelope (it raises there)")
    g = torch.Generator(device=cuda).manual_seed(11)
    y = torch.randn((*shape, 8 * C), generator=g, device=cuda).to(in_dtype)
    sub = (torch.randn((shape[0], 8 * C), generator=g, device=cuda)
           if with_sub else None)
    fn = getattr(kr, f"depth_to_space_{which}_ndhwc")
    plain = getattr(kr, f"depth_to_space_{which}_ndhwc_plain")
    n = fn.launches
    got = fn(y, sub, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fn.launches == n + 1 and got.dtype == out_dtype
    assert torch.equal(got.cpu(), plain(y, sub, out_dtype=out_dtype).cpu())


@pytest.mark.gpu
def test_fold_kernel_raises_outside_envelope(cuda):
    from anatomix_tpu_torch.kernels import reshuffle as kr

    with pytest.raises(ValueError, match="fold unsupported"):
        kr.depth_to_space_fold_ndhwc(
            torch.zeros((1, 2, 2, 3, 8 * 32), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (1, 6, 4, 2),
                                   (3, 12, 10, 16), (2, 8, 4, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_space_to_depth_c1_kernel_matches_plain(cuda, shape, dtype):
    """Bit for bit against the plain version: the 16-byte-run route (any
    width, aligned pointers) and the scalar route (an odd offset)."""
    from anatomix_tpu_torch.kernels import reshuffle as kr

    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    n = kr.space_to_depth_c1_ndhwc.launches
    got = kr.space_to_depth_c1_ndhwc(x)
    torch.cuda.synchronize()
    assert kr.space_to_depth_c1_ndhwc.launches == n + 1
    assert torch.equal(got.cpu(), kr.space_to_depth_c1_ndhwc_plain(x).cpu())
    # a view at an odd offset takes the element-wise loads
    flat = torch.randn(x.numel() + 1, generator=g, device=cuda).to(dtype)
    xv = flat[1:].view(shape)
    assert torch.equal(kr.space_to_depth_c1_ndhwc(xv).cpu(),
                       kr.space_to_depth_c1_ndhwc_plain(xv).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("C", [32, 12])
def test_norm_apply_split_kernel_matches_plain(cuda, C):
    """The three-term split store [hi | lo | hi] and its residual, against
    the plain version: hi + lo holds the f32 value to about 2^-17 of it,
    and an ulp of difference in the f32 affine (the kernel's fused
    multiply-add) can move lo's rounding by that much, so 2^-16."""
    g = torch.Generator(device=cuda).manual_seed(13)
    shape = (2, 6, 4, 8, C)
    x = torch.randn(shape, generator=g, device=cuda)
    a = torch.rand((2, 1, 1, 1, C), generator=g, device=cuda) + 0.5
    s = torch.randn((2, 1, 1, 1, C), generator=g, device=cuda)
    r = norm_apply_ndhwc_plain(
        torch.randn(shape, generator=g, device=cuda), a, s,
        tile_maps(shape[1:4], (1, 1, 1), cuda), split=True)
    maps = tile_maps(shape[1:4], (1, 1, 1), cuda)
    for res in (None, r):
        got = norm_apply_ndhwc(x, a, s, maps, act="lrelu", slope=0.01,
                               residual=res, split=True)
        ref = norm_apply_ndhwc_plain(x, a, s, maps, act="lrelu", slope=0.01,
                                     residual=res, split=True)
        torch.cuda.synchronize()
        assert got.shape == (*shape[:4], 3 * C)
        hi, lo = got[..., :C].float(), got[..., C:2 * C].float()
        rhi, rlo = ref[..., :C].float(), ref[..., C:2 * C].float()
        assert torch.equal(got[..., :C], got[..., 2 * C:])
        assert _maxrel((hi + lo).cpu(), (rhi + rlo).cpu()) < 2.0 ** -16


@pytest.mark.gpu
def test_scatter_kernel_reads_bf16_windows(cuda):
    r, C = 16, 32
    axes, minv = gaussian_importance_axes((r, r, r), 0.25)
    gd, gh, gw = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                  for a in axes)
    starts = torch.tensor([[0, 0, 0], [5, 3, 7]], dtype=torch.int32,
                          device=cuda)
    mask = torch.tensor([1, 1], dtype=torch.int32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(14)
    out = torch.randn((2, r, r, r, C), generator=g, device=cuda).to(
        torch.bfloat16)
    canvas = torch.randn((24, 20, 28, C), generator=g, device=cuda)
    got = blend_scatter(canvas.clone(), out, starts, mask, gd, gh, gw, minv)
    ref = blend_scatter_plain(canvas.clone(), out, starts, mask, gd, gh, gw,
                              minv)
    torch.cuda.synchronize()
    assert _maxrel(got.cpu(), ref.cpu()) < 1e-5


def _reflect_shell_mask(shape, edge, device):
    """(D, H, W) bool: voxels with some axis index in {1, n-2} (`edge`:
    also {0, n-1})."""
    def axis(n):
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[[1, n - 2] + ([0, n - 1] if edge else [])] = True
        return m
    mz, my, mx = (axis(n) for n in shape)
    return mz[:, None, None] | my[None, :, None] | mx[None, None]


@pytest.mark.gpu
@pytest.mark.parametrize("B,spatial,co,ci,route", [
    (1, (2, 7, 9), 8, 16, "brick"),   # extent 2: every voxel in the shell
    (2, (3, 5, 4), 16, 8, "brick"),   # extent 3: one shell index
    (1, (10, 3, 17), 16, 48, "brick"),
    (1, (5, 6, 7), 8, 12, "brick"),   # ci % 8 != 0: the scalar shell pass
    (2, (30, 30, 30), 64, 16, "chunked brick"),
    (2, (20, 20, 20), 32, 96, "ring"),
    (2, (9, 11, 6), 32, 96, "split"),
    (2, (8, 8, 8), 256, 256, "split"),   # the step's 8^3 256 -> 256
])
def test_reflect_dgrad_split_store_and_shell_pass(cuda, B, spatial, co, ci,
                                                  route):
    """The reflect dgrad on each store path (halo brick, chunked brick,
    gather ring, split K) at mixed and odd extents: against its plain
    version (1e-2), on the voxels with some axis index in {0, 1, S-2, S-1}
    alone (1e-2 of their max), two launches bit for bit; one split store
    and one shell pass a call; the split store alone final off the shell,
    and the shell pass bit for bit its plain version on the same g_ext."""
    from anatomix_tpu_torch.kernels import conv_train as kt
    from anatomix_tpu_torch.kernels.conv import conv_plan

    plan = conv_plan(B, tuple(s + 2 for s in spatial), co, ci)
    assert route == ("split" if plan.splits > 1 else "ring" if not plan.brick
                     else "chunked brick" if plan.chunk < -(-co // 16) * 16
                     else "brick")
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn((B, *spatial, co), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * (2.0 / (27 * ci)) ** 0.5).bfloat16()
    n = (kt.conv3x3x3_dgrad_ndhwc.launches, kt.pad_shell_ndhwc.launches)
    dx = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type="reflect")
    again = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type="reflect")
    torch.cuda.synchronize()
    assert (kt.conv3x3x3_dgrad_ndhwc.launches,
            kt.pad_shell_ndhwc.launches) == (n[0] + 2, n[1] + 2)
    ref = kt.conv3x3x3_dgrad_ndhwc_plain(dy, w, pad_type="reflect")
    assert dx.dtype == torch.bfloat16 and dx.shape == (B, *spatial, ci)
    assert _maxrel(dx.float().cpu(), ref.float().cpu()) < 1e-2
    edge = _reflect_shell_mask(spatial, True, cuda)
    assert _maxrel(dx.float()[:, edge].cpu(), ref.float()[:, edge].cpu()) \
        < 1e-2
    assert torch.equal(dx, again)
    st, g_ext = kt.pad_dgrad_store(dy, w)
    torch.cuda.synchronize()
    off = ~_reflect_shell_mask(spatial, False, cuda)
    assert torch.equal(st[:, off], dx[:, off])
    assert torch.equal(kt.pad_shell_ndhwc(g_ext, st.clone()),
                       kt.pad_shell_plain(g_ext, st.clone()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,spatial,C", [
    (2, (2, 2, 2), 8), (1, (3, 3, 3), 16), (2, (2, 5, 9), 8),
    (1, (8, 5, 3), 48), (2, (16, 16, 16), 16), (1, (7, 4, 9), 12),
    (1, (34, 18, 10), 1),
])
def test_reflect_shell_kernel_matches_plain_bit_for_bit(cuda, B, spatial,
                                                        C):
    """The shell pass on f32 g_ext (16-byte path at C % 8 == 0, scalar
    otherwise) writes every shell voxel with its plain version's bits and
    leaves every other voxel of dx as it was."""
    from anatomix_tpu_torch.kernels import conv_train as kt

    g = torch.Generator(device=cuda).manual_seed(8)
    g_ext = torch.randn((B, *(s + 2 for s in spatial), C), generator=g,
                        device=cuda)
    dx0 = torch.randn((B, *spatial, C), generator=g, device=cuda).bfloat16()
    n = kt.pad_shell_ndhwc.launches
    got = kt.pad_shell_ndhwc(g_ext, dx0.clone())
    torch.cuda.synchronize()
    assert kt.pad_shell_ndhwc.launches == n + 1
    assert torch.equal(got, kt.pad_shell_plain(g_ext, dx0.clone()))
    off = ~_reflect_shell_mask(spatial, False, cuda)
    assert torch.equal(got[:, off], dx0[:, off])


@pytest.mark.gpu
def test_zeros_dgrad_and_k1_take_no_shell_pass(cuda):
    """The zero-padded dgrad and the K1 forward against their plain
    versions, neither launching the reflect shell pass."""
    from anatomix_tpu_torch.kernels import conv_train as kt

    g = torch.Generator(device=cuda).manual_seed(9)
    dy = torch.randn((2, 6, 7, 5, 16), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * 16, 16), generator=g, device=cuda)
         * 0.1).bfloat16()
    b = torch.randn((16,), generator=g, device=cuda) * 0.1
    n = kt.pad_shell_ndhwc.launches
    dx = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type="zeros")
    y = conv3x3x3_ndhwc(dy, w, b, act="none", pad_type="reflect")
    torch.cuda.synchronize()
    assert kt.pad_shell_ndhwc.launches == n
    assert _maxrel(dx.float().cpu(), kt.conv3x3x3_dgrad_ndhwc_plain(
        dy, w, pad_type="zeros").float().cpu()) < 1e-2
    assert _maxrel(y.float().cpu(), conv3x3x3_ndhwc_plain(
        dy, w, b, act="none", pad_type="reflect").float().cpu()) < 1e-2


@pytest.mark.gpu
def test_register_pair_on_the_card_matches_the_plain_route(cuda):
    """Registration at 64^3 (two spheres three voxels apart, `sliding`,
    the 6M UNet at full width with seeded weights) on the kernels (bf16)
    and on the plain f32 route: the kernels' macro-Dice gains 0.1 over the
    unregistered pair and stays within 0.02 of the plain route's, with
    K1, K3 and K4 launched."""
    from anatomix_tpu_torch.models.load import load_model
    from anatomix_tpu_torch.registration.pipeline import (
        macro_dice,
        register_pair,
    )
    from anatomix_tpu_torch.registration.warp import warp_volume

    def sphere(center, radius=14):
        g = np.stack(np.meshgrid(*[np.arange(64)] * 3, indexing="ij"), -1)
        d = np.linalg.norm(g - np.asarray(center, np.float32), axis=-1)
        return (np.clip(1 - d / radius, 0, 1) * 200).astype(np.float32), (
            d < radius).astype(np.float32)

    fixed, fseg = sphere((32, 32, 32))
    moving, mseg = sphere((35, 30, 33))
    plan, sd = load_model("scratch", allow_scratch=True, device=cuda)
    mseg_t = torch.as_tensor(mseg, device=cuda)[None, ..., None]
    dice = {}
    for route, kw in (("kernels", {}),
                      ("plain", dict(impl="eager",
                                     compute_dtype=torch.float32))):
        n = [conv3x3x3_ndhwc.launches, conv3x3x3_upcat_ndhwc.launches,
             blend_scatter.launches]
        disp, secs = register_pair(fixed, moving, plan, sd, device=cuda,
                                   **kw)
        if route == "kernels":
            assert conv3x3x3_ndhwc.launches > n[0]
            assert conv3x3x3_upcat_ndhwc.launches > n[1]
            assert blend_scatter.launches > n[2]
        assert disp.shape == (1, 64, 64, 64, 3) and secs > 0
        assert torch.isfinite(disp).all()
        moved = warp_volume(mseg_t, disp, mode="nearest")[0, ..., 0]
        dice[route] = macro_dice(fseg, moved.cpu().numpy())
    before = macro_dice(fseg, mseg)
    assert dice["kernels"] >= before + 0.1, (before, dice)
    assert dice["kernels"] >= dice["plain"] - 0.02, dice


@pytest.mark.gpu
def test_edt_on_the_card_equals_the_cpu_bit_for_bit(cuda):
    """The exact EDT at the 96^3 subsample of a 192^3 volume, on the card
    and on the CPU: indices and squared distances equal, ties included
    (the first minimum on both). Two masks: sparse random voxels with six
    voxels at distance 3 around an emptied centre (a six-way tie there),
    and an ellipsoid body (the masked merge's case)."""
    from anatomix_tpu_torch.ops.edt import edt_feature_transform

    n = 96
    rng = np.random.default_rng(0)
    sparse = (rng.random((n,) * 3) < 0.002).astype(np.int32)
    c = n // 2
    sparse[c - 3:c + 4, c - 3:c + 4, c - 3:c + 4] = 0
    for a in range(3):
        for off in (-3, 3):
            q = [c, c, c]
            q[a] += off
            sparse[tuple(q)] = 1
    g = np.indices((n,) * 3) / (n - 1) - 0.5
    body = ((g[0] / 0.42) ** 2 + (g[1] / 0.35) ** 2
            + (g[2] / 0.3) ** 2 <= 1.0).astype(np.int32)
    for mask in (sparse, body):
        idx, dist2 = edt_feature_transform(torch.from_numpy(mask).to(cuda))
        ref_idx, ref_dist2 = edt_feature_transform(torch.from_numpy(mask))
        assert torch.equal(idx.cpu(), ref_idx)
        assert torch.equal(dist2.cpu(), ref_dist2)
        if mask is sparse:
            # six voxels tie at distance 3; the first minimum of the
            # passes (x, then y, then z) takes the one at z - 3
            assert int(dist2[c, c, c]) == 9
            assert idx[:, c, c, c].tolist() == [c, c, c - 3]


@pytest.mark.gpu
def test_segmentation_step_on_the_card_matches_the_plain_route(cuda):
    """Few-shot finetuning of the 6M UNet at full width (seeded weights, 4
    classes, crop 64^3, batch 2) on the kernels (bf16) and on the plain
    f32 route from the same state and batch: the first loss within 1e-2
    relative and three steps' losses within 5e-2 of each other; K1, T-x,
    T-w and the L pair launched by the kernel step; then the eval logits
    of a 96^3 volume with the kernels' parameters through the sliding
    window (K1, K3, and K4 at 5 channels, one launch a chunk) within 3e-2
    of the plain route's on the same parameters (mean|err|/std)."""
    from anatomix_tpu_torch.kernels import conv_train as kt
    from anatomix_tpu_torch.kernels import reshuffle as kr
    from anatomix_tpu_torch.ops.sliding_window import (
        compute_window_starts,
        sliding_window_inference,
    )
    from anatomix_tpu_torch.segmentation import model as pm
    from anatomix_tpu_torch.segmentation import train as ptr

    rng = np.random.default_rng(0)

    def blocks(shape):
        """Labelled boxes on a noisy background: image (..., 1), labels."""
        lab = np.zeros(shape, np.int64)
        for c in range(1, 5):
            for b in range(shape[0]):
                o = rng.integers(0, shape[1] - 24, 3)
                lab[b, o[0]:o[0] + 24, o[1]:o[1] + 24, o[2]:o[2] + 24] = c
        img = lab[..., None] * 0.2 + rng.standard_normal(lab.shape + (1,))
        return (torch.from_numpy(img.astype(np.float32)).to(cuda),
                torch.from_numpy(lab).to(cuda))

    x, y = blocks((2, 64, 64, 64))
    vol, _ = blocks((1, 96, 96, 96))
    chunks = -(-len(compute_window_starts((96,) * 3, (64,) * 3, 0.7)) // 4)
    wrappers = (conv3x3x3_ndhwc, kt.conv3x3x3_dgrad_ndhwc,
                kt.conv3x3x3_wgrad_ndhwc, kr.space_to_depth2_ndhwc,
                kr.depth_to_space2_ndhwc)
    losses = {}
    for plain in (False, True):
        plan, params = pm.load_seg_model(4, ckpt_path="scratch",
                                         device=cuda)
        step = ptr.build_seg_train_step(
            plan, ptr.make_seg_optimizer(params, 1e-3), plain=plain)
        n = [w.launches for w in wrappers]
        losses[plain] = [float(step(params, x, y)) for _ in range(3)]
        if plain:
            continue
        assert all(w.launches > k for w, k in zip(wrappers, n))
        # the kernels' parameters through the fused forward and the plain
        # route; the stitch runs K4 on both
        k4 = blend_scatter.launches
        logits = {p: sliding_window_inference(
            vol, pm.make_seg_predictor(plan, params, plain=p), 5,
            roi_size=(64,) * 3, sw_batch_size=4, overlap=0.7,
            mode="constant") for p in (False, True)}
        assert blend_scatter.launches == k4 + 2 * chunks
    assert abs(losses[False][0] - losses[True][0]) <= 1e-2 * losses[True][0]
    for k, p in zip(losses[False], losses[True]):
        assert abs(k - p) <= 5e-2 * p, losses
    ref = logits[True]
    err = ((logits[False] - ref).abs().mean() / ref.std()).item()
    assert torch.isfinite(logits[False]).all() and err < 3e-2, err


@pytest.mark.gpu
def test_first_dgrad_of_a_process_matches_plain(cuda):
    """The first input-gradient launch of a fresh process, where the
    transposed conv's zero bias is allocated for the first time, against
    its plain version (reflect, split store and shell pass): within 1e-2
    of the largest value. The flipped weights were once a temporary freed
    before the launch, whose memory that first allocation zeroed ahead of
    the kernel (7e-2 here then)."""
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from anatomix_tpu_torch.kernels import conv_train as kt\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "dy = torch.randn((2, 64, 64, 64, 32), generator=g,"
        " device='cuda').to(torch.bfloat16)\n"
        "w = (torch.randn((27 * 32, 32), generator=g, device='cuda')"
        " * 0.05).to(torch.bfloat16)\n"
        "got = kt.conv3x3x3_dgrad_ndhwc(dy, w).float()\n"
        "ref = kt.conv3x3x3_dgrad_ndhwc_plain(dy, w).float()\n"
        "print(((got - ref).abs().max() / ref.abs().max()).item())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert float(out.stdout.strip().splitlines()[-1]) < 1e-2


@pytest.mark.gpu
def test_dev_train_walk_on_the_card_matches_the_plain_walk(cuda):
    """The general train walk of a dev-style UNet (instance norm eps 1e-2,
    Avg pool, trilinear; ngf 8, num_downs 3, a 32^3 batch of 2) in bf16 on
    the kernels (K1 on the three-term split, T-x, T-w) against the f32
    plain walk: the output within 1e-3 mean|err|/std, every conv's dW
    within 5e-2 mean|err|/std; every conv launched K1 and T-w, every conv
    but the entry T-x, each with its shell pass."""
    from anatomix_tpu_torch.kernels import conv_train as kt
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        init_params,
    )
    from anatomix_tpu_torch.models.unet_train import unet_apply_train

    plan = build_plan(UnetConfig(
        output_nc=8, num_downs=3, ngf=8, norm="instance", norm_eps=1e-2,
        pooling="Avg", interp="trilinear"))
    params = {k: v.to(cuda) for k, v in init_params(
        plan, torch.Generator().manual_seed(0)).items()}
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, 32, 32, 32, 1), generator=g, device=cuda)
    cot = torch.randn((2, 32, 32, 32, 8), generator=g, device=cuda)
    wrappers = (conv3x3x3_ndhwc, kt.conv3x3x3_wgrad_ndhwc,
                kt.conv3x3x3_dgrad_ndhwc, kt.pad_shell_ndhwc)
    n_conv = len(plan.conv_indices)
    runs = {}
    for plain in (True, False):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        before = [w.launches for w in wrappers]
        out = unet_apply_train(plan, leaves, x, plain=plain)[0]
        grads = torch.autograd.grad((out * cot).sum(), [
            leaves[f"model.{i}.weight"] for i in plan.conv_indices])
        runs[plain] = (out.detach(), grads)
        if not plain:
            assert [w.launches - b for w, b in zip(wrappers, before)] == [
                n_conv, n_conv, n_conv - 1, n_conv - 1]
    ref, rgrads = runs[True]
    out, grads = runs[False]
    assert out.dtype == torch.float32
    assert ((out - ref).abs().mean() / ref.std()).item() < 1e-3
    for g_k, g_p in zip(grads, rgrads):
        assert ((g_k - g_p).abs().mean() / g_p.std()).item() < 5e-2


# -----------------------------------------------------------------------------
# the parallel paths: K1's D-valid mode, a one-rank NCCL group

@pytest.mark.gpu
@pytest.mark.parametrize("ci,co,pad,act,B,dl", [
    (16, 16, "reflect", "relu", 1, 16),    # the brick
    (96, 32, "reflect", "none", 2, 8),     # a split conv's width, f32 store
    (5, 7, "zeros", "elu", 2, 1),          # one plane, scalar loads
    (256, 256, "reflect", "relu", 2, 4),   # the gather ring, split K
])
def test_dvalid_conv_kernel_matches_plain(cuda, ci, co, pad, act, B, dl):
    """K1's D-valid mode: x (B, Dl + 2, H, W, ci) with its halo planes;
    against its plain version, and against the "same" conv of the volume
    the planes were cut from (rows 1..Dl of it), the same kernel arithmetic
    on the same planes."""
    from anatomix_tpu_torch.kernels.conv import (
        conv3x3x3_dvalid_ndhwc,
        conv3x3x3_dvalid_ndhwc_plain,
    )

    g = torch.Generator(device=cuda).manual_seed(2)
    S = 12
    w = (torch.randn((27 * ci, co), generator=g, device=cuda) * 0.1).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    x = torch.randn((B, dl + 2, S, S + 2, ci), generator=g,
                    device=cuda).bfloat16()
    # f32 out: the two sums of 27 ci products in another order, each up to
    # k ulps (chip_smoke.tol_conv_f32)
    for out_dtype, tol in ((torch.bfloat16, 1e-2),
                           (torch.float32, max(1e-4, 27 * ci * 2.0 ** -24))):
        kw = dict(act=act, slope=0.3, pad_type=pad, out_dtype=out_dtype)
        before = conv3x3x3_dvalid_ndhwc.launches
        got = conv3x3x3_dvalid_ndhwc(x, w, b, **kw)
        ref = conv3x3x3_dvalid_ndhwc_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        assert got.shape == (B, dl, S, S + 2, co)
        assert conv3x3x3_dvalid_ndhwc.launches == before + 1
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol
        # into the interior of a haloed buffer
        if B == 1:
            buf = torch.zeros((1, dl + 2, S, S + 2, co), dtype=out_dtype,
                              device=cuda)
            conv3x3x3_dvalid_ndhwc(x, w, b, out=buf[:, 1:-1], **kw)
            torch.cuda.synchronize()
            assert torch.equal(buf[:, 1:-1], got)
            assert not buf[:, 0].any() and not buf[:, -1].any()
    if pad == "reflect" and dl >= 2:
        # the whole volume: its reflect halo planes make the D-valid conv
        # the "same" conv
        vol = x[:, 1:-1].contiguous()
        halo = torch.cat([vol[:, 1:2], vol, vol[:, -2:-1]], dim=1)
        kw = dict(act=act, slope=0.3, pad_type=pad, out_dtype=torch.float32)
        same = conv3x3x3_ndhwc(vol, w, b, **kw)
        torch.cuda.synchronize()
        assert torch.equal(conv3x3x3_dvalid_ndhwc(halo, w, b, **kw), same)


@pytest.mark.gpu
def test_one_rank_nccl_group_and_halo_exchange(cuda, monkeypatch):
    """A world of one on NCCL: the halo exchange of CUDA tensors is the
    padding alone (reflect, replicate, zeros), the autograd all-reduce is
    the identity forward and backward, and the sharded forward equals
    `full` bit for bit on the same instance-norm statistics: the sharded
    forward keeps the torch statistics (its all-reduce sits between the
    sums and the fold), so `full` takes them too, in place of its
    statistics kernel, which sums in another order."""
    import torch.distributed as dist

    from anatomix_tpu_torch.extract import make_feature_extractor
    from anatomix_tpu_torch.models import unet_fused
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        init_params,
    )
    from anatomix_tpu_torch.parallel.launch import (
        free_port,
        init_local_group,
    )
    from anatomix_tpu_torch.parallel.mesh import all_reduce_sum, space_mesh
    from anatomix_tpu_torch.parallel.spatial import halo_pad_d

    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dev = init_local_group(0, 1, "cuda", free_port())
    try:
        mesh = space_mesh(1, 1, device=dev)
        group = mesh.group("space")
        x = torch.randn((1, 6, 4, 5, 3), device=dev).bfloat16()
        want = {"reflect": (x[:, 1:2], x[:, -2:-1]),
                "replicate": (x[:, :1], x[:, -1:]),
                "zeros": (torch.zeros_like(x[:, :1]),) * 2}
        for pad, (lo, hi) in want.items():
            got = halo_pad_d(x, group, pad)
            assert got.device.type == "cuda"
            assert torch.equal(got, torch.cat([lo, x, hi], dim=1)), pad
        t = torch.randn(5, device=dev, requires_grad=True)
        y = all_reduce_sum(t * 2.0, group)
        y.sum().backward()
        assert torch.equal(y, t.detach() * 2.0)
        assert torch.equal(t.grad, torch.full_like(t, 2.0))
        plan = build_plan(UnetConfig(input_nc=1, output_nc=4, num_downs=2,
                                     ngf=4, norm="instance", pooling="Avg",
                                     interp="trilinear", norm_eps=1e-2))
        sd = init_params(plan, torch.Generator().manual_seed(0))
        vol = torch.rand((1, 16, 16, 16, 1), device=dev)
        monkeypatch.setattr(unet_fused, "norm_stats_ndhwc",
                            norm_stats_ndhwc_plain)
        full = make_feature_extractor(plan, sd, strategy="full", device=dev)
        sharded = make_feature_extractor(plan, sd, strategy="full",
                                         device=dev, mesh=mesh)
        assert torch.equal(sharded(vol), full(vol))
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_trainer_on_the_card_named_without_an_index(cuda):
    """`train(cfg)` with `device="cuda"` (its default, no index): the batch
    pipeline's worker thread binds to the caller's card. Two runs of the
    dry run's trainer phase at world 1 log the same first loss, and the
    later ones within `TOL_TRAIN` (T-w's f32 atomics make each update
    differ run to run)."""
    from anatomix_tpu_torch.parallel.dryrun import TOL_TRAIN, trainer_losses

    t = trainer_losses(1, "cuda")
    assert len(t["one"]) == 2 and len(t["one_val"]) == 1
    assert np.isfinite(t["one"] + t["one_val"]).all()
    assert t["dp"][0] == t["one"][0]
    np.testing.assert_allclose(t["dp"] + t["dp_val"], t["one"] + t["one_val"],
                               rtol=TOL_TRAIN[torch.bfloat16])


# -----------------------------------------------------------------------------
# the UNet options: pad modes, SELU, PReLU's slope, the residual block's
# norm-apply pass, lifted 1-D and 2-D nets, the ordered T-w

@pytest.mark.gpu
@pytest.mark.parametrize("pad,spatial,ci,co,act", [
    ("replicate", (5, 7, 9), 5, 7, "relu"),
    ("circular", (5, 7, 9), 12, 20, "selu"),
    ("replicate", (1, 1, 1), 8, 8, "none"),   # extent 1
    ("circular", (1, 3, 1), 16, 16, "lrelu"),
    ("circular", (9, 10, 11), 96, 33, "selu"),   # the gather ring
    (("zeros", "reflect", "reflect"), (1, 33, 17), 16, 16, "relu"),
    (("zeros", "zeros", "replicate"), (1, 1, 70), 1, 16, "relu"),
])
def test_conv_pad_modes_and_selu_match_plain(cuda, pad, spatial, ci, co,
                                             act):
    """K1 under replicate and circular padding (extents of 1 included),
    the SELU epilogue, PReLU's slope, and a lifted net's per-axis padding,
    at odd extents and widths, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn((2, *spatial, ci), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * 0.2).bfloat16()
    b = torch.randn((co,), generator=g, device=cuda)
    for out_dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-4)):
        kw = dict(act=act, slope=-0.11, pad_type=pad, out_dtype=out_dtype)
        got = conv3x3x3_ndhwc(x, w, b, **kw)
        ref = conv3x3x3_ndhwc_plain(x, w, b, **kw)
        torch.cuda.synchronize()
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < tol


@pytest.mark.gpu
@pytest.mark.parametrize("pad", ["replicate", "circular"])
def test_two_operand_convs_pad_modes_match_plain(cuda, pad):
    """K3 and D3 under replicate and circular padding at odd widths."""
    g = torch.Generator(device=cuda).manual_seed(11)
    enc = torch.randn((2, 6, 10, 8, 12), generator=g, device=cuda).bfloat16()
    small = torch.randn((2, 3, 5, 4, 20), generator=g, device=cuda).bfloat16()
    up = torch.randn((2, 6, 10, 8, 20), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * 32, 24), generator=g, device=cuda)
         * 0.1).bfloat16()
    b = torch.randn((24,), generator=g, device=cuda)
    kw = dict(act="relu", pad_type=pad)
    for fn, plain, second in (
            (conv3x3x3_upcat_ndhwc, conv3x3x3_upcat_ndhwc_plain, small),
            (conv3x3x3_cat_ndhwc, conv3x3x3_cat_ndhwc_plain, up)):
        got = fn(enc, second, w, b, **kw)
        ref = plain(enc, second, w, b, **kw)
        torch.cuda.synchronize()
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("pad,B,spatial,co,ci", [
    ("replicate", 1, (1, 1, 1), 8, 8),
    ("circular", 1, (1, 4, 2), 16, 8),
    ("replicate", 2, (5, 6, 7), 12, 20),
    ("circular", 2, (9, 11, 6), 32, 96),   # split K
    ("circular", 2, (30, 30, 30), 64, 16),
    (("zeros", "reflect", "reflect"), 2, (1, 20, 24), 16, 16),
])
def test_padded_dgrad_split_store_and_shell_pass(cuda, pad, B, spatial, co,
                                                 ci):
    """T-x under replicate, circular and a lifted net's per-axis padding:
    against its plain version, two launches bit for bit, the shell pass
    bit for bit its plain version on the same g_ext."""
    from anatomix_tpu_torch.kernels import conv_train as kt

    g = torch.Generator(device=cuda).manual_seed(12)
    dy = torch.randn((B, *spatial, co), generator=g, device=cuda).bfloat16()
    w = (torch.randn((27 * ci, co), generator=g, device=cuda)
         * (2.0 / (27 * ci)) ** 0.5).bfloat16()
    dx = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type=pad)
    again = kt.conv3x3x3_dgrad_ndhwc(dy, w, pad_type=pad)
    ref = kt.conv3x3x3_dgrad_ndhwc_plain(dy, w, pad_type=pad)
    torch.cuda.synchronize()
    assert _maxrel(dx.float().cpu(), ref.float().cpu()) < 1e-2
    assert torch.equal(dx, again)
    st, g_ext = kt.pad_dgrad_store(dy, w, pad)
    assert torch.equal(kt.pad_shell_ndhwc(g_ext, st.clone(), pad),
                       kt.pad_shell_plain(g_ext, st.clone(), pad))


@pytest.mark.gpu
@pytest.mark.parametrize("pad,B,grid,ci,co,kind", [
    ("reflect", 2, (32, 32, 32), 16, 16, "halo"),
    ("replicate", 2, (17, 9, 11), 16, 16, "halo"),
    ("circular", 1, (1, 5, 3), 8, 12, "halo"),
    ("circular", 2, (20, 20, 20), 96, 32, "ring"),
    ("replicate", 2, (4, 4, 4), 256, 256, "ring"),
    (("zeros", "reflect", "reflect"), 4, (1, 64, 64), 16, 16, "halo"),
])
def test_wgrad_repeats_bit_for_bit_and_matches_plain(cuda, pad, B, grid, ci,
                                                     co, kind):
    """T-w on each plan kind (halo brick, gather ring; split or not) under
    each padding: against its plain version, and two launches bit for bit
    (P5: the splits' partials summed in split order, no atomics)."""
    from anatomix_tpu_torch.kernels import conv_train as kt

    plan = kt.wgrad_plan(B, grid, ci, co)
    assert bool(plan.halo) == (kind == "halo")
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn((B, *grid, ci), generator=g, device=cuda).bfloat16()
    dy = torch.randn((B, *grid, co), generator=g, device=cuda).bfloat16()
    got = kt.conv3x3x3_wgrad_ndhwc(x, dy, pad_type=pad)
    again = kt.conv3x3x3_wgrad_ndhwc(x, dy, pad_type=pad)
    ref = kt.conv3x3x3_wgrad_ndhwc_plain(x, dy, pad_type=pad)
    torch.cuda.synchronize()
    assert _maxrel(got.cpu(), ref.cpu()) < 1e-3
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("act,post_res,split,x_dtype", [
    ("selu", False, False, torch.float32),
    ("selu", False, True, torch.float32),
    ("relu", True, False, torch.bfloat16),
    ("lrelu", True, True, torch.float32),
    ("selu", True, False, torch.float32),
])
def test_norm_apply_selu_and_residual_match_plain(cuda, act, post_res,
                                                  split, x_dtype):
    """D1 with the SELU epilogue and the residual block's `+ 0.1 x`, at 12
    channels (one a thread) and 16 (eight), split and not."""
    g = torch.Generator(device=cuda).manual_seed(14)
    for C in (12, 16):
        x = torch.randn((2, 5, 6, 7, C), generator=g,
                        device=cuda).to(x_dtype)
        a = torch.rand((2, 1, 1, 1, C), generator=g, device=cuda) + 0.5
        s = torch.randn((2, 1, 1, 1, C), generator=g, device=cuda)
        maps = tile_maps((5, 6, 7), (1, 1, 1), cuda)
        kw = dict(act=act, slope=0.37, split=split, post_res=post_res)
        got = norm_apply_ndhwc(x, a, s, maps, **kw)
        ref = norm_apply_ndhwc_plain(x, a, s, maps, **kw)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        assert _maxrel(got.float().cpu(), ref.float().cpu()) < (
            1e-5 if split else 1e-2)


@pytest.mark.gpu
def test_prelu_pretrain_step_on_the_card(cuda):
    """`build_all(PretrainConfig(actG="prelu"))` at a small crop: the
    loss close to the plain route's, the PReLU weight one leaf that moves,
    and the step from one state twice gives the same bits (P5)."""
    from anatomix_tpu_torch.models.unet import prelu_key
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all

    cfg = PretrainConfig(actG="prelu", crop_size=32, num_patches=128)
    plan, _, state, step = build_all(cfg, 1, device=cuda)
    _, _, _, plain = build_all(cfg, 1, device=cuda, plain=True)
    g = torch.Generator(device=cuda).manual_seed(15)
    views = torch.rand((1, 2, 32, 32, 32, 1), generator=g, device=cuda)
    segs = torch.randint(0, 4, (1, 32, 32, 32, 1), generator=g, device=cuda)
    runs = [step(state, views, segs,
                 torch.Generator(device=cuda).manual_seed(3))
            for _ in range(2)]
    _, mp = plain(state, views, segs,
                  torch.Generator(device=cuda).manual_seed(3))
    (s1, m1), (s2, m2) = runs
    key = prelu_key(plan)
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(s1.params_g[k], s2.params_g[k])
               for k in s1.params_g)
    assert abs(float(m1["loss"]) - float(mp["loss"])) < 1e-2 * abs(
        float(mp["loss"]))
    assert float(s1.params_g[key]) != float(state.params_g[key])


@pytest.mark.gpu
def test_2d_unet_forward_on_the_card(cuda):
    """A 2-D UNet (the 6M widths) through `make_feature_extractor` on the
    kernels against the eager f32 module, under the bf16 model tolerance,
    its convs launched on K1 and D3."""
    from anatomix_tpu_torch.extract import make_feature_extractor
    from anatomix_tpu_torch.kernels import conv as kc
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        init_params,
    )

    plan = build_plan(UnetConfig(dimension=2, num_downs=4, ngf=16))
    sd = {k: v.to(cuda) for k, v in init_params(
        plan, torch.Generator().manual_seed(0)).items()}
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.rand((2, 96, 80, 1), generator=g, device=cuda)
    n = (kc.conv3x3x3_ndhwc.launches, kc.conv3x3x3_cat_ndhwc.launches)
    got = make_feature_extractor(plan, sd, strategy="full", device=cuda)(x)
    ref = make_feature_extractor(plan, sd, strategy="full", impl="eager",
                                 device=cuda)(x)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (2, 96, 80, 16)
    assert kc.conv3x3x3_ndhwc.launches > n[0]
    assert kc.conv3x3x3_cat_ndhwc.launches > n[1]
    err = ((got - ref).abs().mean() / ref.std()).item()
    assert err < 3e-2
