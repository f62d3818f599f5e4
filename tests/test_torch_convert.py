"""Weight carry-over and loading of the port (`models/registry.py`,
`convert.py`, `load.py`) against the JAX package, on the CPU."""

import jax
import numpy as np
import pytest
import torch

from anatomix_tpu.extract import fold_batchnorm as jax_fold_batchnorm
from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.models.load import load_model as jax_load_model
from anatomix_tpu.models.load import save_npz as jax_save_npz
from anatomix_tpu.models.registry import ANATOMIX_VARIANTS as JAX_VARIANTS
from anatomix_tpu_torch.extract import fold_batchnorm
from anatomix_tpu_torch.models.convert import (
    from_jax_params,
    load_pth,
    strip_prefixes,
    to_jax_params,
)
from anatomix_tpu_torch.models.load import load_from_hf, load_model
from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
from anatomix_tpu_torch.models.unet import (
    Unet,
    UnetConfig,
    build_plan,
    init_params,
)

SMALL = dict(dimension=3, input_nc=1, output_nc=8, num_downs=2, ngf=8)


def _jax_params(cfg_kw, seed=0):
    plan = jax_unet.build_plan(jax_unet.UnetConfig(**cfg_kw))
    params = jax_unet.init_params(plan, jax.random.PRNGKey(seed))
    return plan, jax.tree_util.tree_map(np.asarray, params)


def test_registry_matches_jax():
    assert ANATOMIX_VARIANTS == JAX_VARIANTS


@pytest.mark.parametrize("variant", ["anatomix", "anatomix-dev"])
def test_build_plan_matches_jax(variant):
    kw = ANATOMIX_VARIANTS[variant]["unet_kwargs"]
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(**kw))
    plan = build_plan(UnetConfig(**kw))
    as_tuples = lambda p: [(s.kind, s.in_ch, s.out_ch) for s in p.layers]  # noqa: E731
    assert as_tuples(plan) == as_tuples(jplan)
    for attr in ("encoder_idx", "decoder_idx", "res_source", "res_dest"):
        assert getattr(plan, attr) == getattr(jplan, attr)
    taps = (27, 31, 38, 45, 52, 65) if variant == "anatomix" else (10, 20)
    assert plan.tap_channels(taps) == jplan.tap_channels(taps)


def test_jax_params_round_trip_exactly():
    jplan, params = _jax_params(SMALL)
    plan = build_plan(UnetConfig(**SMALL))
    sd = from_jax_params(plan, params)
    assert sd["model.0.weight"].shape == (8, 1, 3, 3, 3)
    assert {"model.1.running_mean", "model.1.num_batches_tracked"} <= set(sd)
    back = to_jax_params(plan, sd)
    assert set(back) == set(params)
    for idx, sub in params.items():
        assert set(back[idx]) == set(sub)
        for leaf, val in sub.items():
            np.testing.assert_array_equal(back[idx][leaf], val)
    # the state dict loads into the eager module under the reference keys
    Unet.from_state_dict(plan, sd)


def test_fold_batchnorm_matches_jax():
    cfg = dict(SMALL)
    jplan, params = _jax_params(cfg, seed=3)
    rng = np.random.default_rng(0)
    for idx, spec in enumerate(jplan.layers):  # non-trivial running stats
        if spec.kind == "norm":
            params[str(idx)]["mean"] = rng.standard_normal(
                spec.out_ch).astype(np.float32)
            params[str(idx)]["var"] = rng.uniform(
                0.5, 2.0, spec.out_ch).astype(np.float32)
    jfplan, jfparams = jax_fold_batchnorm(jplan, params)
    plan = build_plan(UnetConfig(**cfg))
    fplan, fsd = fold_batchnorm(plan, from_jax_params(plan, params))
    assert [s.kind for s in fplan.layers] == [s.kind for s in jfplan.layers]
    got = to_jax_params(fplan, fsd)
    assert set(got) == set(jfparams)
    for idx, sub in jfparams.items():
        for leaf, val in sub.items():
            np.testing.assert_allclose(got[idx][leaf], val, rtol=1e-6,
                                       atol=1e-7)


def test_strip_prefixes_and_pth_loader(tmp_path):
    plan = build_plan(UnetConfig(**SMALL))
    sd = init_params(plan, torch.Generator().manual_seed(0))
    wrapped = {f"_orig_mod.module.{k}": v for k, v in sd.items()}
    assert set(strip_prefixes(wrapped)) == set(sd)
    path = tmp_path / "ckpt.pth"
    torch.save(wrapped, path)
    loaded = load_pth(str(path), plan)
    for k, v in sd.items():
        assert torch.equal(loaded[k], v)
    bad = dict(sd)
    bad["model.999.weight"] = torch.zeros(1)
    torch.save(bad, path)
    with pytest.raises(ValueError, match="unconsumed"):
        load_pth(str(path), plan)


def test_load_model_reads_jax_npz(tmp_path):
    """A checkpoint in the JAX package's native .npz format loads into the
    port without JAX; both packages then hold the same weights."""
    path = str(tmp_path / "w.npz")
    jplan, params = _jax_params(dict(SMALL, output_nc=16, ngf=16), seed=5)
    jax_save_npz(path, params)
    plan, sd = load_model(path, num_downs=2, ngf=16, device="cpu")
    _, jparams = jax_load_model(path, num_downs=2, ngf=16)
    back = to_jax_params(plan, sd)
    for idx, sub in jparams.items():
        for leaf, val in sub.items():
            np.testing.assert_array_equal(back[idx][leaf], val)


def test_load_model_scratch_and_variants(tmp_path):
    with pytest.raises(ValueError, match="registration"):
        load_model("scratch", device="cpu")
    plan, sd = load_model("scratch", allow_scratch=True, seed=7, num_downs=2,
                          ngf=8, device="cpu")
    _, sd2 = load_model("scratch", allow_scratch=True, seed=7, num_downs=2,
                        ngf=8, device="cpu")
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    with pytest.raises(ValueError, match="cache_path"):
        load_model(hf_variant="anatomix", device="cpu")
    # the ViT variant loads too (tests/test_torch_vit.py), from a local file
    with pytest.raises(ValueError, match="cache_path"):
        load_from_hf("anatomix-dev-vit", device="cpu")
    full = build_plan(UnetConfig(**ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"]))
    path = tmp_path / "anatomix.pth"
    torch.save(init_params(full, torch.Generator().manual_seed(1)), path)
    vplan, vsd = load_model(hf_variant="anatomix", cache_path=str(path),
                            device="cpu")
    assert vplan == full and len(vsd) == len(torch.load(path))
