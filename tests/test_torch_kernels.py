"""The port's kernel modules (`anatomix_tpu_torch/kernels/`).

On the CPU each wrapper runs its plain version; those are held against the
JAX package's Pallas kernels in interpret mode, at the tolerances of the
JAX tests that run them (`tests/test_conv_block.py`,
`tests/test_pallas_conv.py`, `tests/test_sliding_window.py`), and against
the XLA conv at production block extents (ROADMAP F3). The CUDA kernels
themselves are tested in `test_torch_gpu.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.ops.conv import conv3d as jax_conv3d
from anatomix_tpu.ops.pallas.conv3x3 import (
    _depth_to_space,
    _space_to_depth,
    conv3x3_same,
)
from anatomix_tpu.ops.pallas.conv_block import (
    conv_block_sparse,
    conv_block_sparse_skip,
    prepack_sparse,
    prepack_sparse_skip,
)
from anatomix_tpu.ops.pallas.scatter import blend_scatter_fold, lane_tables
from anatomix_tpu.ops.resize import upsample2x as jax_upsample2x
from anatomix_tpu_torch.kernels import build
from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_ndhwc,
    conv3x3x3_ndhwc_plain,
    conv3x3x3_upcat_ndhwc,
)
from anatomix_tpu_torch.kernels.norm import (
    norm_stats_ndhwc,
    norm_stats_ndhwc_plain,
    stats_plan,
)
from anatomix_tpu_torch.kernels.scatter import blend_scatter
from anatomix_tpu_torch.ops.conv import dhwio_to_torch, pack_conv_weight
from anatomix_tpu_torch.ops.norms import (
    fold_affine,
    instance_norm_stats,
    tile_sizes,
)
from anatomix_tpu_torch.ops.sliding_window import gaussian_importance_axes


def _packed(w_dhwio: np.ndarray) -> torch.Tensor:
    return pack_conv_weight(dhwio_to_torch(torch.from_numpy(w_dhwio)))


def _maxrel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# -----------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)

@pytest.mark.parametrize(
    "ci,co,pad,act",
    [(3, 5, "zeros", "none"), (16, 16, "reflect", "lrelu"),
     (8, 4, "zeros", "relu")],
)
def test_conv_plain_matches_pallas_sparse_block(ci, co, pad, act):
    """K1 `conv_block_sparse` (block layout, interpret mode). Its epilogue
    hard-codes LeakyReLU slope 0.2 (ROADMAP F2); the port passes it."""
    rng = np.random.default_rng(ci * 10 + co)
    x = rng.standard_normal((2, 8, 8, 8, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    packed = prepack_sparse(w, b, act=act, compute_dtype=jnp.float32)
    ref = np.asarray(_depth_to_space(conv_block_sparse(
        _space_to_depth(jnp.asarray(x)), packed, pad_type=pad,
        interpret=True)))
    got = conv3x3x3_ndhwc(
        torch.from_numpy(x), _packed(w), torch.from_numpy(b), act=act,
        slope=0.2, pad_type=pad, out_dtype=torch.float32)
    assert _maxrel(got, ref) < 2e-2


@pytest.mark.parametrize(
    "cin,cout,pad,s2d",
    [(1, 8, "reflect", "on"), (4, 6, "zeros", "off"),
     (16, 16, "reflect", "on")],
)
def test_conv_plain_matches_pallas_conv3x3(cin, cout, pad, s2d):
    """K2 `_conv3x3_valid` through `conv3x3_same` (interpret mode): the
    Ci=1 entry conv and the direct form."""
    rng = np.random.default_rng(cin * 10 + cout)
    x = rng.standard_normal((2, 8, 8, 8, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = np.asarray(conv3x3_same(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad_type=pad,
        compute_dtype=jnp.float32, s2d=s2d, interpret=True))
    got = conv3x3x3_ndhwc(torch.from_numpy(x), _packed(w),
                          torch.from_numpy(b), pad_type=pad,
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("c1,c2,co,pad",
                         [(4, 6, 5, "reflect"), (16, 8, 16, "zeros")])
def test_upcat_plain_matches_pallas_skip(c1, c2, co, pad):
    """K3 `conv_block_sparse_skip`: upsample + concat + conv, fused."""
    rng = np.random.default_rng(c1 + c2 + co)
    enc = rng.standard_normal((1, 8, 8, 8, c1)).astype(np.float32)
    small = rng.standard_normal((1, 4, 4, 4, c2)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, c1 + c2, co)) * 0.1).astype(
        np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    packed = prepack_sparse_skip(w, b, c1=c1, act="lrelu",
                                 compute_dtype=jnp.float32)
    ref = np.asarray(_depth_to_space(conv_block_sparse_skip(
        _space_to_depth(jnp.asarray(enc)), jnp.asarray(small), packed,
        pad_type=pad, interpret=True)))
    got = conv3x3x3_upcat_ndhwc(
        torch.from_numpy(enc), torch.from_numpy(small), _packed(w),
        torch.from_numpy(b), act="lrelu", slope=0.2, pad_type=pad,
        out_dtype=torch.float32)
    assert _maxrel(got, ref) < 2e-2


@pytest.mark.parametrize("mode", ["gaussian", "constant"])
def test_scatter_plain_matches_pallas_fold(mode):
    """K4 `blend_scatter_fold` (interpret mode): overlapping windows, one
    masked padding window, the clamp before the mask. The port's canvas
    (D, H, W, C) is the JAX folded canvas (D, H, W*C/128, 128) reshaped."""
    rng = np.random.default_rng(7)
    D, H, W, C, r = 32, 24, 32, 16, 16
    if mode == "gaussian":
        axes, minv = gaussian_importance_axes((r, r, r), 0.25)
    else:
        axes, minv = [np.ones(r)] * 3, 0.0
    starts = np.array([[0, 0, 0], [5, 3, 7], [16, 8, 16], [0, 0, 0]],
                      np.int32)
    mask = np.array([1, 1, 1, 0], np.int32)
    canvas = rng.standard_normal((D, H, W, C)).astype(np.float32)
    out = rng.standard_normal((4, r, r, r, C)).astype(np.float32)
    gdh, gw = lane_tables(axes, C)
    ref = np.asarray(blend_scatter_fold(
        jnp.asarray(canvas.reshape(D, H, W * C // 128, 128)),
        jnp.asarray(out.reshape(4, r, r, r * C // 128, 128)),
        jnp.asarray(starts), jnp.asarray(mask), jnp.asarray(gdh),
        jnp.asarray(gw).reshape(r * C // 128, 128), C=C, minv=float(minv),
        interpret=True)).reshape(D, H, W, C)
    g = [torch.as_tensor(a, dtype=torch.float32) for a in axes]
    got = blend_scatter(torch.from_numpy(canvas.copy()), torch.from_numpy(out),
                        torch.from_numpy(starts), torch.from_numpy(mask),
                        *g, minv)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-6)


# -----------------------------------------------------------------------------
# plain versions against the XLA conv at production block extents (F3)

@pytest.mark.parametrize("pad", ["reflect", "zeros"])
def test_conv_plain_matches_xla_at_64(pad):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 64, 64, 64, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 16, 16)) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    ref = np.asarray(jax_conv3d(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), padding="SAME",
                                pad_type=pad))
    got = conv3x3x3_ndhwc(torch.from_numpy(x), _packed(w),
                          torch.from_numpy(b), act="relu", pad_type=pad,
                          out_dtype=torch.float32)
    assert _maxrel(got, np.maximum(ref, 0)) < 1e-5


def test_upcat_plain_matches_xla_at_64():
    rng = np.random.default_rng(12)
    enc = rng.standard_normal((1, 64, 64, 64, 8)).astype(np.float32)
    small = rng.standard_normal((1, 32, 32, 32, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 24, 8)) * 0.1).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    cat = jnp.concatenate(
        [jnp.asarray(enc), jax_upsample2x(jnp.asarray(small))], axis=-1)
    ref = np.asarray(jax_conv3d(cat, jnp.asarray(w), jnp.asarray(b),
                                padding="SAME", pad_type="reflect"))
    got = conv3x3x3_upcat_ndhwc(
        torch.from_numpy(enc), torch.from_numpy(small), _packed(w),
        torch.from_numpy(b), pad_type="reflect", out_dtype=torch.float32)
    assert _maxrel(got, ref) < 1e-5


def test_cpu_wrappers_run_plain_and_count_nothing():
    """A CPU tensor takes the plain version: no build, no launch counted."""
    x = torch.randn(1, 4, 4, 4, 2)
    w = torch.randn(27 * 2, 3)
    b = torch.zeros(3)
    before = conv3x3x3_ndhwc.launches
    y = conv3x3x3_ndhwc(x, w, b, act="relu", pad_type="zeros",
                        out_dtype=torch.float32)
    assert torch.equal(y, conv3x3x3_ndhwc_plain(
        x, w, b, act="relu", pad_type="zeros", out_dtype=torch.float32))
    assert conv3x3x3_ndhwc.launches == before
    assert build.SOURCES == ("conv3d", "blend_scatter", "norm_apply",
                             "upsample", "flash_attention",
                             "depth_to_space8", "conv3d_wgrad", "reshuffle")
    # the ViT's kernels take their plain versions on the CPU too
    from anatomix_tpu_torch.kernels.attention import flash_attention
    from anatomix_tpu_torch.kernels.conv_down import conv_down2_ndhwc
    from anatomix_tpu_torch.kernels.conv_train import (
        conv3x3x3_dgrad_ndhwc,
        conv3x3x3_wgrad_ndhwc,
    )
    from anatomix_tpu_torch.kernels.reshuffle import (
        depth_to_space2_ndhwc,
        depth_to_space8_ndhwc,
        space_to_depth2_ndhwc,
    )

    wrappers = (conv_down2_ndhwc, flash_attention, depth_to_space8_ndhwc,
                conv3x3x3_wgrad_ndhwc, conv3x3x3_dgrad_ndhwc,
                space_to_depth2_ndhwc, depth_to_space2_ndhwc)
    counts = [f.launches for f in wrappers]
    conv_down2_ndhwc(x, w, b)
    q = torch.randn(1, 2, 5, 4)
    flash_attention(q, q, q, 0.5)
    depth_to_space8_ndhwc(torch.randn(1, 1, 1, 1, 512))
    # and the conv's backward kernels (the pretraining step)
    dy = torch.randn(1, 4, 4, 4, 3)
    conv3x3x3_wgrad_ndhwc(x, dy, pad_type="zeros")
    conv3x3x3_dgrad_ndhwc(dy, w, pad_type="zeros")
    # and the block-layout permutations of its train walk
    depth_to_space2_ndhwc(space_to_depth2_ndhwc(x))
    assert [f.launches for f in wrappers] == counts


# -----------------------------------------------------------------------------
# the instance-norm statistics and their affine fold (`norm_stats_ndhwc`)

def _stats_f64(x, tiles, eps, scale, bias):
    """(a, s) of each (sample, tile, channel) in float64, from the tile's
    own voxels of the sample's own window."""
    x = x.double().numpy()
    B, C = x.shape[0], x.shape[-1]
    sizes = tile_sizes(x.shape[1:4], tiles)
    a = np.empty((B,) + tuple(map(len, sizes)) + (C,))
    s = np.empty_like(a)
    edges = [np.concatenate([[0], np.cumsum(sz)]) for sz in sizes]
    for b in range(B):
        for tz in range(len(sizes[0])):
            for ty in range(len(sizes[1])):
                for tx in range(len(sizes[2])):
                    box = x[b, edges[0][tz]:edges[0][tz + 1],
                            edges[1][ty]:edges[1][ty + 1],
                            edges[2][tx]:edges[2][tx + 1]].reshape(-1, C)
                    inv = 1.0 / np.sqrt(box.var(axis=0) + eps)
                    if scale is not None:
                        inv = inv * scale.double().numpy()
                    shift = -box.mean(axis=0) * inv
                    if bias is not None:
                        shift = shift + bias.double().numpy()
                    a[b, tz, ty, tx], s[b, tz, ty, tx] = inv, shift
    return a, s


@pytest.mark.parametrize("shape,tiles,affine,dtype", [
    ((2, 8, 8, 8, 16), (1, 1, 1), False, torch.float32),   # global, B=2
    ((2, 8, 8, 8, 16), (1, 1, 1), True, torch.bfloat16),
    ((2, 8, 12, 8, 32), (2, 2, 2), True, torch.float32),   # even tiles
    ((1, 88, 6, 5, 8), (3, 1, 2), False, torch.float32),   # 88 in 3 tiles
    ((1, 88, 6, 5, 8), (3, 1, 2), True, torch.bfloat16),
    ((2, 6, 5, 7, 12), (2, 1, 3), False, torch.bfloat16),  # C % 8 != 0
])
def test_norm_stats_plain_and_cpu_wrapper(shape, tiles, affine, dtype):
    """`norm_stats_ndhwc_plain` is `instance_norm_stats` then `fold_affine`;
    on a CPU tensor the wrapper returns it and counts no launch. Each
    window of the batch (another offset and scale a sample) is normalised
    on its own, as float64 statistics of its own tiles say."""
    rng = np.random.default_rng(11)
    B, C = shape[0], shape[-1]
    x = rng.standard_normal(shape) * (1.0 + np.arange(B)).reshape(
        -1, 1, 1, 1, 1) + rng.standard_normal((B, 1, 1, 1, C)) * 3.0
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    scale = bias = None
    if affine:
        scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
        bias = torch.from_numpy(rng.standard_normal(C).astype(np.float32))
    eps = 1e-2
    mean, var = instance_norm_stats(x, tiles)
    want = fold_affine(mean, var, eps, scale, bias)
    plain = norm_stats_ndhwc_plain(x, tiles, eps=eps, scale=scale, bias=bias)
    before = norm_stats_ndhwc.launches
    got = norm_stats_ndhwc(x, tiles, eps=eps, scale=scale, bias=bias)
    assert norm_stats_ndhwc.launches == before
    n_tiles = tuple(map(len, tile_sizes(shape[1:4], tiles)))
    for w, p, g, r in zip(want, plain, got,
                          _stats_f64(x, tiles, eps, scale, bias)):
        assert w.dtype == torch.float32
        assert w.shape == (B,) + n_tiles + (C,)
        assert torch.equal(p, w) and torch.equal(g, w)
        assert _maxrel(w, r) < 1e-5


@pytest.mark.parametrize("B,spatial,C,tiles,width", [
    (2, (128, 128, 128), 32, (1, 1, 1), 4),   # the dev path's first level
    (2, (4, 4, 4), 1024, (1, 1, 1), 4),       # its bottleneck
    (1, (88, 20, 22), 32, (3, 2, 3), 4),      # uneven tiles
    (1, (40, 40, 40), 32, (3, 3, 3), 8),      # bf16
    (2, (6, 5, 7), 12, (2, 1, 3), 1),         # one channel a thread
    (1, (9, 3, 2), 2048, (2, 1, 1), 4),       # two channel chunks
])
def test_norm_stats_walk_covers_each_voxel_once(B, spatial, C, tiles, width):
    """Pass 1's walk (`csrc/norm_apply.cu` norm_stats_partial_kernel),
    replayed for every thread at once: each voxel of each tile is read
    once, inside its tile, and the grid fills an H100's 132 SMs wherever
    the tiles hold enough voxels."""
    sizes = tile_sizes(spatial, tiles)
    edges = [np.concatenate([[0], np.cumsum(sz)]) for sz in sizes]
    n_tiles = len(sizes[0]) * len(sizes[1]) * len(sizes[2])
    nblk = stats_plan(C, B * n_tiles,
                      min(sizes[0]) * min(sizes[1]) * min(sizes[2]), width,
                      132)
    groups = C // width
    per_block = min(groups, 256)
    lanes = 256 // per_block
    chunks = -(-groups // per_block)
    if B * n_tiles * min(sizes[0]) * min(sizes[1]) * min(sizes[2]) >= 2**20:
        assert B * n_tiles * nblk * chunks >= 132 * 8
    seen = np.zeros((B,) + tuple(spatial), np.int64)
    for t in range(n_tiles):
        tz, ty, tx = np.unravel_index(t, tuple(map(len, sizes)))
        z0, y0, x0 = edges[0][tz], edges[1][ty], edges[2][tx]
        dz, dy, dx = sizes[0][tz], sizes[1][ty], sizes[2][tx]
        n = dz * dy * dx
        chunk = -(-n // nblk)
        k, lane = np.meshgrid(np.arange(nblk), np.arange(lanes),
                              indexing="ij")
        i = (k * chunk + lane).ravel()
        end = np.minimum(n, (k.ravel() + 1) * chunk)
        ix, r = i % dx, i // dx
        iy, iz = r % dy, r // dy
        sx, q = lanes % dx, lanes // dx
        sy, sz = q % dy, q // dy
        while (live := i < end).any():
            assert (ix[live] < dx).all() and (iy[live] < dy).all()
            assert (iz[live] < dz).all()
            np.add.at(seen, (slice(None), z0 + iz[live], y0 + iy[live],
                             x0 + ix[live]), 1)
            ix, iy, iz = ix + sx, iy + sy, iz + sz
            wrap = ix >= dx
            ix, iy = ix - wrap * dx, iy + wrap
            wrap = iy >= dy
            iy, iz = iy - wrap * dy, iz + wrap
            i = i + lanes
    assert (seen == 1).all()
