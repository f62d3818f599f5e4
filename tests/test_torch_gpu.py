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
from anatomix_tpu_torch.ops.norms import tile_maps
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
@pytest.mark.parametrize("B,H,N,hd", [
    (1, 6, 4104, 66),   # the ViT's window at B=1: a ragged key tail
    (2, 2, 129, 66),    # one key past a tile
    (1, 3, 50, 32),     # fewer keys than one tile
    (2, 1, 200, 128),
])
def test_flash_attention_kernel_matches_plain(cuda, B, H, N, hd):
    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((B, H, N, hd), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    scale = hd ** -0.5
    got = flash_attention(q, k, v, scale)
    ref = flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert _maxrel(got.float().cpu(), ref.float().cpu()) < 1e-2


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
@pytest.mark.parametrize("which,shape,dtype", [
    ("s2d", (2, 16, 8, 12, 16), torch.bfloat16),
    ("s2d", (1, 4, 6, 2, 3), torch.bfloat16),   # 6-byte runs: 2-byte units
    ("s2d", (1, 6, 4, 8, 5), torch.float32),
    ("d2s", (2, 8, 4, 6, 8 * 32), torch.bfloat16),
    ("d2s", (1, 3, 2, 5, 8 * 3), torch.bfloat16),
    ("d2s", (1, 2, 3, 4, 8 * 6), torch.float32),
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
    wrappers = (wgrad, dgrad, kr.space_to_depth2_ndhwc,
                kr.depth_to_space2_ndhwc)
    before = [fn.launches for fn in wrappers]
    state, metrics = step(state, views, segs,
                          torch.Generator(device=cuda).manual_seed(3))
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    # each pool and upsample permutes forward and backward
    n_resize = sum(spec.kind in ("pool", "upsample") for spec in plan.layers)
    assert [fn.launches - n for fn, n in zip(wrappers, before)] == [
        n_conv, n_conv - 1, n_resize, n_resize]
