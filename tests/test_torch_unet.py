"""The port's UNet forwards against the JAX `unet_apply` in f32 on the CPU:
the eager `Unet` (with taps) and the BN-folded kernel forward
(`models/unet_fused.py`, whose kernel wrappers run their plain versions on
CPU tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.extract import fold_batchnorm as jax_fold_batchnorm
from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu_torch.extract import fold_batchnorm
from anatomix_tpu_torch.models.convert import from_jax_params
from anatomix_tpu_torch.models.unet import Unet, UnetConfig, build_plan
from anatomix_tpu_torch.models.unet_fused import (
    prepack_fused,
    unet_apply_fused,
)

MODEL_TOL = 1e-4  # relative to max |ref|

CONFIGS = {
    "anatomix_small": dict(num_downs=2, ngf=8, output_nc=8),
    # ROADMAP F2: the UNet's LeakyReLU slope is 0.3 in `unet_apply`
    "lrelu_zeros": dict(num_downs=2, ngf=8, output_nc=4, activation="lrelu",
                        pad_type="zeros", final_act="tanh"),
    "nonorm_noskip": dict(num_downs=2, ngf=8, output_nc=4, norm="none",
                          use_skip_connection=False, pooling="Avg"),
}


def _models(name, seed=0):
    kw = dict(dimension=3, input_nc=1, **CONFIGS[name])
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, jax_unet.init_params(jplan, jax.random.PRNGKey(seed)))
    plan = build_plan(UnetConfig(**kw))
    return jplan, params, plan, from_jax_params(plan, params)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eager_unet_matches_unet_apply(name):
    jplan, params, plan, sd = _models(name)
    x = np.random.default_rng(1).standard_normal(
        (2, 16, 12, 20, 1)).astype(np.float32)
    ref = jax_unet.unet_apply(jplan, params, jnp.asarray(x),
                              compute_dtype=jnp.float32)
    net = Unet.from_state_dict(plan, sd)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == ref.shape
    assert _rel(got, ref) < MODEL_TOL


def test_eager_unet_taps_and_encode_only():
    jplan, params, plan, sd = _models("anatomix_small")
    x = np.random.default_rng(2).standard_normal(
        (1, 16, 16, 16, 1)).astype(np.float32)
    taps = (2, 9, 13, 21)
    ref_out, ref_feats = jax_unet.unet_apply(
        jplan, params, jnp.asarray(x), layers=taps, compute_dtype=jnp.float32)
    net = Unet.from_state_dict(plan, sd)
    with torch.no_grad():
        out, feats = net(torch.from_numpy(x), layers=taps)
        enc = net(torch.from_numpy(x), layers=taps[:2], encode_only=True)
    assert _rel(out, ref_out) < MODEL_TOL
    assert len(feats) == len(ref_feats) == len(taps)
    for g, r in zip(feats, ref_feats):
        assert g.shape == r.shape
        assert _rel(g, r) < MODEL_TOL
    assert len(enc) == 2 and torch.equal(enc[1], feats[1])
    assert plan.tap_channels(taps) == tuple(f.shape[-1] for f in feats)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fused_forward_matches_unet_apply(name):
    """The kernel forward (BN folded, activations in the conv epilogue,
    decoder convs on the up-concat kernel) in f32 against the JAX XLA
    UNet on the same folded weights."""
    jplan, params, plan, sd = _models(name, seed=4)
    x = np.random.default_rng(3).standard_normal(
        (2, 16, 12, 20, 1)).astype(np.float32)
    jfplan, jfparams = jax_fold_batchnorm(jplan, params)
    ref = jax_unet.unet_apply(
        jfplan, jax.tree_util.tree_map(jnp.asarray, jfparams),
        jnp.asarray(x), compute_dtype=jnp.float32)
    fplan, fsd = fold_batchnorm(plan, sd)
    packed = prepack_fused(fplan, fsd, device="cpu",
                           compute_dtype=torch.float32)
    got = unet_apply_fused(fplan, packed, torch.from_numpy(x),
                           compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel(got, ref) < MODEL_TOL


def test_prepack_needs_folded_plan_and_supported_config():
    _, _, plan, sd = _models("anatomix_small")
    with pytest.raises(ValueError, match="fold"):
        prepack_fused(plan, sd, device="cpu")
    for kw, item in [(dict(norm="group"), "unsupported"),
                     (dict(interp="bicubic"), "unsupported")]:
        cfg = UnetConfig(num_downs=2, ngf=8, **kw)
        with pytest.raises(NotImplementedError, match=item):
            Unet(build_plan(cfg))
    # residual and PReLU UNets build and pack: a residual batch norm stays
    # live (its conv is a residual source), PReLU runs as the lrelu
    # epilogue with the shared weight's value as its slope
    rplan = build_plan(UnetConfig(num_downs=2, ngf=8,
                                  residual_connection=True))
    rsd = Unet(rplan).state_dict()
    fplan, fsd = fold_batchnorm(rplan, rsd)
    assert fplan.layers == rplan.layers
    packed = prepack_fused(fplan, fsd, device="cpu")
    assert packed[0]["act"] == "none" and packed[0]["f32_out"]
    assert packed[0]["block"]["norm"] == "batch"
    assert packed[0]["block"]["act"] == "relu"
    pplan = build_plan(UnetConfig(num_downs=2, ngf=8, activation="prelu"))
    psd = Unet(pplan).state_dict()
    psd = {k: (torch.full_like(v, 0.37) if k.endswith(".weight")
               and v.shape == (1,) else v) for k, v in psd.items()}
    fplan, fsd = fold_batchnorm(pplan, psd)
    packed = prepack_fused(fplan, fsd, device="cpu")
    assert packed[0]["act"] == "lrelu"
    assert packed[0]["slope"] == pytest.approx(0.37)
    # the dev family (live instance norm, trilinear) packs unfolded
    dev = build_plan(UnetConfig(num_downs=2, ngf=8, norm="instance",
                                interp="trilinear", pooling="Avg"))
    packed = prepack_fused(dev, Unet(dev).state_dict(), device="cpu")
    assert packed[0]["act"] == "none" and packed[1]["act"] == "relu"
