"""The port's slice as a whole on the CPU: sliding-window pieces, feature
normalizations, `make_feature_extractor` ('full' and 'sliding') and the
CLI, against the JAX package on the same numpy inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu import extract as jax_extract
from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.models.load import save_npz as jax_save_npz
from anatomix_tpu.ops import sliding_window as jax_sw
from anatomix_tpu_torch import extract
from anatomix_tpu_torch.extract_cli import main as cli_main
from anatomix_tpu_torch.models.convert import from_jax_params
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan
from anatomix_tpu_torch.ops import sliding_window as sw

SLICE_TOL = 1e-4  # relative to max |ref|
CFG = dict(dimension=3, input_nc=1, output_nc=8, num_downs=2, ngf=8)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def models():
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(**CFG))
    params = jax.tree_util.tree_map(
        np.asarray, jax_unet.init_params(jplan, jax.random.PRNGKey(0)))
    plan = build_plan(UnetConfig(**CFG))
    return jplan, params, plan, from_jax_params(plan, params)


def test_window_layout_matches_jax():
    for img, roi, ov in [((256,) * 3, (128,) * 3, 0.8),
                         ((40, 36, 33), (16,) * 3, 0.5),
                         ((16,) * 3, (16,) * 3, 0.8)]:
        np.testing.assert_array_equal(
            sw.compute_window_starts(img, roi, ov),
            jax_sw.compute_window_starts(img, roi, ov))
    assert len(sw.compute_window_starts((256,) * 3, (128,) * 3, 0.8)) == 343


@pytest.mark.parametrize("roi", [(128, 128, 128), (16, 20, 12)])
def test_importance_map_and_weight_map_match_jax(roi):
    axes, minv = sw.gaussian_importance_axes(roi, 0.25)
    jaxes, jminv = jax_sw.gaussian_importance_axes(roi, 0.25)
    for a, b in zip(axes, jaxes):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-15)
    assert minv == pytest.approx(jminv, rel=1e-12)
    imp = sw.gaussian_importance_map(roi, 0.25)
    np.testing.assert_allclose(imp, jax_sw.gaussian_importance_map(roi, 0.25),
                               rtol=1e-6)
    img = tuple(2 * r + 3 for r in roi)
    starts = sw.compute_window_starts(img, roi, 0.5)
    np.testing.assert_allclose(
        sw.blend_weight_map(img, starts, imp).numpy(),
        jax_sw.blend_weight_map(img, starts, imp), rtol=1e-6)


def test_pad_to_roi_matches_jax():
    vol = np.random.default_rng(0).standard_normal(
        (1, 10, 16, 12, 2)).astype(np.float32)
    got, crops = sw.pad_to_roi(torch.from_numpy(vol), (16, 16, 16))
    ref, jcrops = jax_sw._pad_to_roi(jnp.asarray(vol), (16, 16, 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert [tuple(c) for c in crops] == [tuple(c) for c in jcrops]


def test_sliding_window_inference_matches_jax_toy_model():
    """The stitch alone (a channel-mixing toy model, padded last chunk,
    volume smaller than roi on one axis)."""
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((1, 40, 36, 12, 2)).astype(np.float32)
    mix = np.linspace(-1, 1, 2 * 16, dtype=np.float32).reshape(2, 16)

    def jfn(w):
        return jnp.tanh(w @ jnp.asarray(mix))

    def tfn(w):
        return torch.tanh(w @ torch.from_numpy(mix))

    kw = dict(roi_size=(16, 16, 16), sw_batch_size=3, overlap=0.5,
              mode="gaussian")
    ref = jax_sw.sliding_window_inference(jnp.asarray(vol), jfn, 16, **kw)
    got = sw.sliding_window_inference(torch.from_numpy(vol), tfn, 16, **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)


def test_importance_tables_are_made_once_and_shared():
    """The Gaussian tables a window loop blends with are built once per
    roi, sigma, mode and device, equal the uncached maps, and stay normal
    tensors when the first call ran in inference mode."""
    roi = (12, 10, 8)
    sw.importance_tables.cache_clear()
    vol = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 20, 17, 8, 1)).astype(np.float32))
    kw = dict(roi_size=roi, sw_batch_size=2, overlap=0.5, mode="gaussian")
    with torch.inference_mode():
        first = sw.sliding_window_inference(vol, torch.tanh, 1, **kw)
    second = sw.sliding_window_inference(vol, torch.tanh, 1, **kw)
    assert torch.equal(first, second)
    info = sw.importance_tables.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    imp, factors, minv = sw.importance_tables(roi, 0.25, "gaussian",
                                              torch.device("cpu"))
    np.testing.assert_array_equal(imp.numpy(),
                                  sw.gaussian_importance_map(roi, 0.25))
    axes, ref_minv = sw.gaussian_importance_axes(roi, 0.25)
    for f, a in zip(factors, axes):
        np.testing.assert_array_equal(f.numpy(), a.astype(np.float32))
    assert minv == ref_minv
    assert not imp.is_inference()
    w = torch.ones(roi[2], requires_grad=True)
    (factors[2] * w).sum().backward()
    np.testing.assert_array_equal(w.grad.numpy(), axes[2].astype(np.float32))


def test_normalizations_match_jax():
    rng = np.random.default_rng(2)
    arr = rng.uniform(-100, 900, (6, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(extract.minmax(arr, -50, 500),
                               jax_extract.minmax(arr, -50, 500), rtol=1e-6)
    feats = rng.standard_normal((1, 3, 4, 5, 16)).astype(np.float32)
    for name in ("unit_normalize", "zscore_normalize"):
        got = getattr(extract, name)(torch.from_numpy(feats))
        ref = getattr(jax_extract, name)(jnp.asarray(feats))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("strategy", ["full", "sliding"])
def test_feature_extractor_matches_jax(models, strategy):
    """The slice: port `make_feature_extractor(device='cpu')` (BN folded,
    the kernel forward on the kernels' plain f32 versions, the stitch on
    `blend_scatter`'s) against the JAX XLA path in f32."""
    jplan, params, plan, sd = models
    vol = np.random.default_rng(3).uniform(
        0, 1, (1, 40, 30, 34, 1)).astype(np.float32)
    kw = dict(strategy=strategy, roi_size=(16, 16, 16), overlap=0.5,
              sw_batch_size=2)
    ref = jax_extract.make_feature_extractor(
        jplan, params, conv_impl="xla", compute_dtype=jnp.float32, **kw)(
        jnp.asarray(vol))
    got = extract.make_feature_extractor(
        plan, sd, compute_dtype=torch.float32, device="cpu", **kw)(vol)
    assert got.shape == ref.shape == (1, 40, 30, 34, 8)
    assert _rel(got, ref) < SLICE_TOL
    eager = extract.make_feature_extractor(plan, sd, impl="eager",
                                           device="cpu", **kw)(vol)
    assert _rel(eager, ref) < SLICE_TOL


def test_extractor_auto_and_unsupported(models):
    _, _, plan, sd = models
    vol = np.random.default_rng(4).uniform(0, 1, (1, 16, 16, 16, 1))
    auto = extract.make_feature_extractor(plan, sd, strategy="auto",
                                          device="cpu")(vol)
    full = extract.make_feature_extractor(plan, sd, strategy="full",
                                          device="cpu")(vol)
    assert torch.equal(auto, full)
    # a batch-norm model has no live norm: full_tiled is full
    tiled = extract.make_feature_extractor(
        plan, sd, strategy="full_tiled", roi_size=(8, 8, 8), device="cpu")(vol)
    assert torch.equal(tiled, full)
    with pytest.raises(ValueError, match="Unknown strategy"):
        extract.make_feature_extractor(plan, sd, strategy="tiles",
                                       device="cpu")
    fixed, moving = extract.extract_features(
        vol[0, ..., 0], 2 * vol[0, ..., 0], plan, sd, strategy="full",
        device="cpu", compute_dtype=torch.float32)
    assert fixed.shape == moving.shape == (1, 16, 16, 16, 8)
    # minmax makes the two volumes identical
    assert torch.allclose(fixed, moving, atol=1e-6)


def test_cli_matches_jax_extractor(tmp_path, models):
    jplan, params, _, _ = models
    ckpt = str(tmp_path / "w.npz")
    jax_save_npz(ckpt, params)
    vol = np.random.default_rng(5).uniform(0, 100, (20, 24, 16)).astype(
        np.float32)
    np.save(tmp_path / "ct.npy", vol)
    out = str(tmp_path / "feats.npz")
    cli_main(["--input", str(tmp_path / "ct.npy"), "--output", out,
              "--ckpt_path", ckpt, "--num_downs", "2", "--ngf", "8",
              "--output_nc", "8", "--strategy", "full", "--dtype",
              "float32", "--device", "cpu", "--normalize", "unit"])
    got = np.load(out)["features"]
    ref = jax_extract.unit_normalize(jax_extract.make_feature_extractor(
        jplan, params, strategy="full", conv_impl="xla",
        compute_dtype=jnp.float32)(
        jnp.asarray(jax_extract.minmax(vol)[None, ..., None])))[0]
    assert got.shape == (20, 24, 16, 8)
    assert _rel(got, ref) < SLICE_TOL
    # dataset mode
    (tmp_path / "in").mkdir()
    for i in range(3):
        np.save(tmp_path / "in" / f"v{i}.npy", vol * (i + 1))
    cli_main(["--input_dir", str(tmp_path / "in"), "--output_dir",
              str(tmp_path / "out"), "--pattern", "*.npy", "--ckpt_path",
              ckpt, "--num_downs", "2", "--ngf", "8", "--output_nc", "8",
              "--strategy", "full", "--dtype", "float32", "--device",
              "cpu"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "v0.npz", "v1.npz", "v2.npz"]
