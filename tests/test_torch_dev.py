"""The dev slice of the port (the 94M `anatomix-dev` UNet's path: instance
norm, Avg pool, trilinear decoder, `full_tiled`) against the JAX package on
the CPU, on the same numpy inputs and weights (`from_jax_params`).

Per module: the norms, the trilinear upsample, the plain versions of the
three kernels of the slice (norm apply, trilinear, cat conv) against the
JAX ops and the Pallas kernels in interpret mode. Then the slice as a
whole: the fused forward against JAX `unet_apply_fused` (interpret mode,
so D1-D3 run as Pallas) and `unet_apply` (XLA), the three strategies of
`make_feature_extractor` against the JAX extractor, `instance_affine`, and
a `.pth` of the dev topology through `load_from_hf` and the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu import extract as jax_extract
from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.models import unet_fused as jax_fused
from anatomix_tpu.ops import norms as jax_norms
from anatomix_tpu.ops.conv import conv3d as jax_conv3d
from anatomix_tpu.ops.pallas.norm_apply import norm_apply_block
from anatomix_tpu.ops.pallas.upsample import upsample2x_trilinear_block_pallas
from anatomix_tpu.ops.pool import avg_pool as jax_avg_pool
from anatomix_tpu.ops.resize import upsample2x as jax_upsample2x
from anatomix_tpu_torch import extract
from anatomix_tpu_torch.extract_cli import main as cli_main
from anatomix_tpu_torch.kernels.conv import (
    conv3x3x3_cat_ndhwc,
    conv3x3x3_ndhwc,
)
from anatomix_tpu_torch.kernels.norm import norm_apply_ndhwc
from anatomix_tpu_torch.kernels.resize import upsample2x_trilinear_ndhwc
from anatomix_tpu_torch.models.convert import from_jax_params, to_jax_params
from anatomix_tpu_torch.models.load import load_from_hf
from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
from anatomix_tpu_torch.models.unet import (
    Unet,
    UnetConfig,
    build_plan,
    init_params,
)
from anatomix_tpu_torch.models.unet_fused import (
    prepack_fused,
    unet_apply_fused,
)
from anatomix_tpu_torch.ops import norms
from anatomix_tpu_torch.ops.conv import (
    dhwio_to_torch,
    pack_conv_weight,
    split3,
)
from anatomix_tpu_torch.ops.pool import avg_pool
from anatomix_tpu_torch.ops.resize import upsample2x

NORM_TOL = 1e-5    # relative, f32: one-pass moments in the same order
OP_TOL = 1e-6      # trilinear: the same four-term sums per axis
CONV_TOL = 1e-4    # f32 conv sums in another order
MODEL_TOL = 1e-3   # of max |ref|: f32 forwards through 13 convs and norms
DEV_SMALL = dict(dimension=3, input_nc=1, output_nc=8, num_downs=2, ngf=16,
                 norm="instance", pooling="Avg", interp="trilinear",
                 norm_eps=1e-2)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _randn(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _models(cfg_kw, seed=0):
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(**cfg_kw))
    params = jax.tree_util.tree_map(
        np.asarray, jax_unet.init_params(jplan, jax.random.PRNGKey(seed)))
    plan = build_plan(UnetConfig(**cfg_kw))
    return jplan, params, plan


# -----------------------------------------------------------------------------
# modules

@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_matches_jax(affine):
    x = _randn(0, (2, 16, 12, 10, 8), 2.0, 0.5)
    scale = _randn(1, (8,), 0.2, 1.0) if affine else None
    bias = _randn(2, (8,), 0.3) if affine else None
    ref = jax_norms.instance_norm(
        jnp.asarray(x), eps=1e-2,
        scale=None if scale is None else jnp.asarray(scale),
        bias=None if bias is None else jnp.asarray(bias))
    got = norms.instance_norm(
        torch.from_numpy(x), eps=1e-2,
        scale=None if scale is None else torch.from_numpy(scale),
        bias=None if bias is None else torch.from_numpy(bias))
    assert _rel(got, ref) < NORM_TOL


@pytest.mark.parametrize("size,tiles", [(16, (2, 2, 2)), (40, (3, 3, 3)),
                                        (20, (1, 2, 3))])
def test_tiled_instance_norm_matches_jax(size, tiles):
    x = _randn(size, (2, size, size, size, 4), 1.5, -0.3)
    scale, bias = _randn(3, (4,), 0.2, 1.0), _randn(4, (4,), 0.3)
    for s, b in ((None, None), (scale, bias)):
        ref = jax_norms.tiled_instance_norm(
            jnp.asarray(x), tiles, eps=1e-2,
            scale=None if s is None else jnp.asarray(s),
            bias=None if b is None else jnp.asarray(b))
        got = norms.tiled_instance_norm(
            torch.from_numpy(x), tiles, eps=1e-2,
            scale=None if s is None else torch.from_numpy(s),
            bias=None if b is None else torch.from_numpy(b))
        assert _rel(got, ref) < NORM_TOL


def test_instance_norm_stats_per_sample_and_tile():
    """Statistics reduce over space only: the two windows of a `sliding`
    chunk are normalized each on its own, and a zero (padding) window
    stays finite with eps 1e-2."""
    x = _randn(5, (2, 12, 10, 9, 3))
    x[1] = 0.0
    mean, var = norms.instance_norm_stats(torch.from_numpy(x), (3, 2, 1))
    assert mean.shape == var.shape == (2, 3, 2, 1, 3)
    sizes = norms.tile_sizes((12, 10, 9), (3, 2, 1))
    z0 = 0
    for i, dz in enumerate(sizes[0]):
        y0 = 0
        for j, dy in enumerate(sizes[1]):
            t = x[0, z0:z0 + dz, y0:y0 + dy].reshape(-1, 3)
            np.testing.assert_allclose(mean[0, i, j, 0], t.mean(0),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(var[0, i, j, 0], t.var(0),
                                       rtol=1e-4, atol=1e-6)
            y0 += dy
        z0 += dz
    assert torch.all(mean[1] == 0) and torch.all(var[1] == 0)
    y = norms.tiled_instance_norm(torch.from_numpy(x), (3, 2, 1), eps=1e-2)
    assert torch.isfinite(y).all() and torch.all(y[1] == 0)


def test_even_chunk_sizes_and_tile_maps():
    """The copy of `_even_chunk_sizes` is the JAX one; each level's maps
    come from its own extent, and the halving invariant makes a level's
    tile boundaries twice the next level's."""
    for size in range(1, 70):
        for n in range(1, 5):
            if size < n:
                with pytest.raises(ValueError):
                    norms._even_chunk_sizes(size, n)
                continue
            assert norms._even_chunk_sizes(size, n) == \
                jax_norms._even_chunk_sizes(size, n)
    for size, n in [(256, 2), (352, 3), (40, 3)]:
        while size // 2 >= n and size % 2 == 0:
            (fine,) = norms.tile_maps((size,), (n,), "cpu")
            (coarse,) = norms.tile_maps((size // 2,), (n,), "cpu")
            assert fine.dtype == torch.int32
            assert torch.equal(fine[::2], coarse)
            size //= 2


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 3), (1, 4, 4, 4, 16)])
def test_trilinear_matches_jax(shape):
    x = _randn(6, shape)
    ref = jax_upsample2x(jnp.asarray(x), "trilinear")
    got = upsample2x(torch.from_numpy(x), "trilinear")
    assert got.shape == ref.shape
    assert _rel(got, ref) < OP_TOL
    with pytest.raises(ValueError):
        upsample2x(torch.from_numpy(x), "bicubic")


def test_trilinear_plain_matches_pallas_block():
    """D2 `upsample2x_trilinear_block_pallas` (interpret mode) emits the
    (B, s, s, s, 8C) block layout with (sub_d, sub_h, sub_w)-major
    channels; unfolded here to NDHWC."""
    x = _randn(7, (2, 4, 6, 8, 16))
    blk = np.asarray(upsample2x_trilinear_block_pallas(
        jnp.asarray(x), interpret=True))
    B, d, h, w, c8 = blk.shape
    C = c8 // 8
    ref = blk.reshape(B, d, h, w, 2, 2, 2, C).transpose(
        0, 1, 4, 2, 5, 3, 6, 7).reshape(B, 2 * d, 2 * h, 2 * w, C)
    got = upsample2x_trilinear_ndhwc(torch.from_numpy(x))
    assert got.shape == ref.shape
    assert _rel(got, ref) < NORM_TOL


@pytest.mark.parametrize("act", ["relu", "none"])
def test_norm_apply_plain_matches_pallas(act):
    """D1 `norm_apply_block` (interpret mode), tiles (2, 2, 2), f32, on
    extents that `_even_chunk_sizes` splits evenly (the kernel's domain)."""
    x = _randn(8, (2, 8, 4, 16, 16))
    a = _randn(9, (2, 2, 2, 2, 16), 0.5, 1.0)
    s = _randn(10, (2, 2, 2, 2, 16), 0.5)
    ref = norm_apply_block(jnp.asarray(x), jnp.asarray(a), jnp.asarray(s),
                           tile_counts=(2, 2, 2), act=act, interpret=True)
    maps = norms.tile_maps((8, 4, 16), (2, 2, 2), "cpu")
    got = norm_apply_ndhwc(torch.from_numpy(x), torch.from_numpy(a),
                           torch.from_numpy(s), maps, act=act,
                           out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _rel(got, ref) < NORM_TOL


def test_norm_apply_uneven_tiles_match_jax_tiled_norm():
    """The fused path's norm (torch statistics, folded affine, the apply
    pass with lrelu) on uneven (3, 3, 3) tiles of 40^3 against the JAX
    `tiled_instance_norm` followed by the activation."""
    x = _randn(11, (1, 40, 40, 40, 4), 1.2, 0.4)
    scale, bias = _randn(12, (4,), 0.2, 1.0), _randn(13, (4,), 0.3)
    ref = jax.nn.leaky_relu(jax_norms.tiled_instance_norm(
        jnp.asarray(x), (3, 3, 3), eps=1e-2, scale=jnp.asarray(scale),
        bias=jnp.asarray(bias)), 0.3)
    xt = torch.from_numpy(x)
    mean, var = norms.instance_norm_stats(xt, (3, 3, 3))
    a, s = norms.fold_affine(mean, var, 1e-2, torch.from_numpy(scale),
                             torch.from_numpy(bias))
    got = norm_apply_ndhwc(xt, a, s, norms.tile_maps(xt.shape[1:4], (3, 3, 3),
                                                     "cpu"),
                           act="lrelu", slope=0.3, out_dtype=torch.float32)
    assert _rel(got, ref) < NORM_TOL


@pytest.mark.parametrize("pad", ["reflect", "zeros"])
def test_cat_conv_plain_matches_jax_conv(pad):
    """D3's function: the conv over concat(enc, up) at one resolution."""
    enc = _randn(14, (2, 8, 6, 10, 16))
    up = _randn(15, (2, 8, 6, 10, 32))
    w = _randn(16, (3, 3, 3, 48, 16), 0.1)
    b = _randn(17, (16,))
    ref = jax_conv3d(jnp.concatenate([jnp.asarray(enc), jnp.asarray(up)], -1),
                     jnp.asarray(w), jnp.asarray(b), padding="SAME",
                     pad_type=pad)
    got = conv3x3x3_cat_ndhwc(
        torch.from_numpy(enc), torch.from_numpy(up),
        pack_conv_weight(dhwio_to_torch(torch.from_numpy(w))),
        torch.from_numpy(b), pad_type=pad, out_dtype=torch.float32)
    assert _rel(got, ref) < CONV_TOL


@pytest.mark.parametrize("shape", [(1, 8, 8, 8, 3), (2, 7, 9, 5, 2)])
def test_avg_pool_matches_jax_odd_and_even(shape):
    x = _randn(18, shape)
    ref = jax_avg_pool(jnp.asarray(x), 2)
    got = avg_pool(torch.from_numpy(x), 2)
    assert got.shape == ref.shape
    assert _rel(got, ref) < NORM_TOL


# -----------------------------------------------------------------------------
# the slice as a whole

@pytest.mark.parametrize("tiles", [None, (2, 2, 2)])
def test_dev_fused_forward_matches_jax(tiles):
    """The port's kernel forward (live instance norm with the act in the
    apply pass, D2 then D3 at each decoder step) in f32 against JAX
    `unet_apply_fused` in interpret mode (D1-D3 as Pallas) and against
    JAX `unet_apply` (XLA)."""
    jplan, params, plan = _models(DEV_SMALL, seed=1)
    rng = np.random.default_rng(2)
    for p in params.values():  # non-zero conv biases
        if "b" in p:
            p["b"] = (rng.standard_normal(p["b"].shape) * 0.1).astype(
                np.float32)
    x = _randn(3, (1, 16, 16, 16, 1))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref_xla = np.asarray(jax_unet.unet_apply(
        jplan, jp, jnp.asarray(x), compute_dtype=jnp.float32,
        in_tile_counts=tiles))
    pf = jax_fused.prepack_fused(jplan, jp, input_spatial=(16, 16, 16),
                                 compute_dtype=jnp.float32, interpret=True)
    ref_pallas = np.asarray(jax_fused.unet_apply_fused(
        jplan, pf, jnp.asarray(x), compute_dtype=jnp.float32,
        interpret=True, in_tile_counts=tiles))
    sd = from_jax_params(plan, params)
    packed = prepack_fused(plan, sd, device="cpu",
                           compute_dtype=torch.float32)
    convs = plan.conv_indices
    assert all(packed[i]["act"] == "none" for i in convs[:-1])
    # convs that feed a live norm store f32; the exit conv feeds none
    assert all(packed[i]["f32_out"] for i in convs[:-1])
    assert not packed[convs[-1]]["f32_out"]
    got = unet_apply_fused(plan, packed, torch.from_numpy(x),
                           compute_dtype=torch.float32, in_tile_counts=tiles)
    assert got.dtype == torch.float32 and got.shape == ref_xla.shape
    assert _rel(got, ref_xla) < MODEL_TOL
    assert _rel(got, ref_pallas) < MODEL_TOL
    eager = Unet.from_state_dict(plan, sd)
    with torch.no_grad():
        got_eager = eager(torch.from_numpy(x), in_tile_counts=tiles)
    assert _rel(got_eager, ref_xla) < MODEL_TOL


def test_dev_entry_conv_reads_the_f32_volume():
    """In bf16, the entry conv of a live-norm model reads the volume and its
    weights through the three-term split ([hi | lo | hi] against [w_hi;
    w_hi; w_lo]): its output is the f32 conv of the unrounded volume with
    the weights the split holds (w_hi + w_lo), not the conv of the
    bf16-rounded volume."""
    _, params, plan = _models(DEV_SMALL, seed=9)
    sd = from_jax_params(plan, params)
    packed = prepack_fused(plan, sd, device="cpu")
    p = packed[0]
    assert p["split"] and p["w"].shape == (27 * 3, 16)
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        0.3, 0.7, (1, 8, 8, 8, 1)).astype(np.float32))
    got = conv3x3x3_ndhwc(split3(x), p["w"], p["b"],
                          out_dtype=torch.float32)
    w3 = p["w"].reshape(27, 3, 16)
    assert torch.equal(w3[:, 0], w3[:, 1])
    assert torch.equal(w3[:, 0], pack_conv_weight(
        sd["model.0.weight"].float()).to(torch.bfloat16))
    w = w3[:, 0].float() + w3[:, 2].float()
    exact = conv3x3x3_ndhwc(x, w, p["b"], out_dtype=torch.float32)
    rounded = conv3x3x3_ndhwc(x.to(torch.bfloat16), w.to(torch.bfloat16),
                              p["b"], out_dtype=torch.float32)
    assert _rel(got, exact) < 1e-5 < _rel(rounded, exact)


def test_dev_instance_affine_matches_jax():
    cfg = dict(DEV_SMALL, norm="instance_affine", activation="lrelu")
    jplan, params, plan = _models(cfg, seed=4)
    rng = np.random.default_rng(5)
    for idx, spec in enumerate(jplan.layers):
        if spec.kind == "norm":
            params[str(idx)] = {
                "scale": (1 + 0.2 * rng.standard_normal(spec.out_ch)).astype(
                    np.float32),
                "bias": (0.2 * rng.standard_normal(spec.out_ch)).astype(
                    np.float32),
            }
    x = _randn(6, (2, 16, 16, 16, 1))
    ref = np.asarray(jax_unet.unet_apply(
        jplan, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        compute_dtype=jnp.float32))
    sd = from_jax_params(plan, params)
    back = to_jax_params(plan, sd)
    for idx, sub in params.items():
        for leaf, val in sub.items():
            np.testing.assert_array_equal(back[idx][leaf], val)
    packed = prepack_fused(plan, sd, device="cpu", compute_dtype=torch.float32)
    got = unet_apply_fused(plan, packed, torch.from_numpy(x),
                           compute_dtype=torch.float32)
    assert _rel(got, ref) < MODEL_TOL
    with torch.no_grad():
        assert _rel(Unet.from_state_dict(plan, sd)(torch.from_numpy(x)),
                    ref) < MODEL_TOL


@pytest.fixture(scope="module")
def dev_small():
    jplan, params, plan = _models(DEV_SMALL, seed=7)
    return jplan, params, plan, from_jax_params(plan, params)


@pytest.mark.parametrize("strategy", ["full_tiled", "sliding", "full"])
def test_dev_extractor_matches_jax(dev_small, strategy):
    """`make_feature_extractor` on a 32^3 volume with roi 16 (full_tiled:
    2x2x2 tiles; sliding: 27 windows in chunks of 2, the last one padded),
    fused and eager, against the JAX extractor (XLA) in f32."""
    jplan, params, plan, sd = dev_small
    vol = np.random.default_rng(8).uniform(0, 1, (1, 32, 32, 32, 1)).astype(
        np.float32)
    kw = dict(strategy=strategy, roi_size=(16, 16, 16), overlap=0.5,
              sw_batch_size=2)
    ref = jax_extract.make_feature_extractor(
        jplan, params, conv_impl="xla", compute_dtype=jnp.float32, **kw)(
        jnp.asarray(vol))
    got = extract.make_feature_extractor(
        plan, sd, compute_dtype=torch.float32, device="cpu", **kw)(vol)
    assert got.shape == ref.shape == (1, 32, 32, 32, 8)
    assert _rel(got, ref) < MODEL_TOL
    eager = extract.make_feature_extractor(plan, sd, impl="eager",
                                           device="cpu", **kw)(vol)
    assert _rel(eager, ref) < MODEL_TOL


def test_dev_auto_picks_sliding(dev_small):
    _, _, plan, sd = dev_small
    vol = np.random.default_rng(9).uniform(0, 1, (1, 20, 16, 16, 1))
    kw = dict(roi_size=(16, 16, 16), overlap=0.5, device="cpu")
    auto = extract.make_feature_extractor(plan, sd, strategy="auto", **kw)
    sliding = extract.make_feature_extractor(plan, sd, strategy="sliding",
                                             **kw)
    assert torch.equal(auto(vol), sliding(vol))


def test_dev_pth_through_load_from_hf_and_cli(tmp_path):
    """A `.pth` of the full 94M dev topology (24 convs with biases, 23
    parameter-free instance norms) loads through `load_from_hf`; the CLI
    with `--hf_variant anatomix-dev --strategy full_tiled` then matches
    the eager extractor on the same weights."""
    kw = ANATOMIX_VARIANTS["anatomix-dev"]["unet_kwargs"]
    plan = build_plan(UnetConfig(**kw))
    sd = init_params(plan, torch.Generator().manual_seed(0))
    assert len(plan.conv_indices) == 24 and len(sd) == 48
    assert max(s.out_ch for s in plan.layers) == 1024
    path = tmp_path / "anatomix-dev.pth"
    torch.save({f"module.{k}": v.half() for k, v in sd.items()}, path)
    vplan, vsd = load_from_hf("anatomix-dev", cache_path=str(path),
                              device="cpu")
    assert vplan == plan and vplan.config.norm_eps == 1e-2
    assert set(vsd) == set(sd)
    for k, v in sd.items():
        assert torch.equal(vsd[k], v.half().float())
    # padded to 64^3, the least extent with 2^3 at the reflect-padded
    # bottleneck; roi 32 gives 2x2x2 tiles
    vol = np.random.default_rng(10).uniform(0, 100, (40, 36, 34)).astype(
        np.float32)
    np.save(tmp_path / "ct.npy", vol)
    out = str(tmp_path / "feats.npz")
    cli_main(["--input", str(tmp_path / "ct.npy"), "--output", out,
              "--hf_variant", "anatomix-dev", "--cache_path", str(path),
              "--strategy", "full_tiled", "--roi", "32", "--dtype",
              "float32", "--device", "cpu"])
    got = np.load(out)["features"]
    ref = extract.make_feature_extractor(
        vplan, vsd, strategy="full_tiled", roi_size=(32, 32, 32),
        impl="eager", device="cpu")(
        extract.minmax(vol)[None, ..., None])[0]
    assert got.shape == (40, 36, 34, 32)
    assert _rel(got, ref) < MODEL_TOL
