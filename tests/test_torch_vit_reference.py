"""The benchmark's plain ViT reference (`gpubench/reference/primus.py`)
against the port and against the JAX package, on the CPU.

The reference is written from the published model's description and
imports neither the port nor JAX; these cases tie it to both on a small v2
configuration with the registry variant's options (qk-norm, the inner
norm, LayerScale, registers, `demean`), on the benchmark's own seeded
weights (`gpubench/synth_vit.py`) and structured volumes.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from anatomix_tpu.models.vit3d import primus as jax_primus  # noqa: E402
from anatomix_tpu_torch.extract import make_feature_extractor  # noqa: E402
from anatomix_tpu_torch.models.vit3d import Primus, PrimusConfig  # noqa: E402
from anatomix_tpu_torch.models.vit3d.convert import (  # noqa: E402
    to_jax_primus_params,
)
from gpubench import synth, synth_vit  # noqa: E402
from gpubench.reference import primus as ref_primus  # noqa: E402
from gpubench.reference import sliding as ref_sliding  # noqa: E402

TOL = 1e-5  # max |port - reference| / max |reference|, both f32
JAX_TOL = 1e-5

# input 16^3 (a 2^3 grid), embed 24, 2 heads of 12, 2 blocks, 2 registers,
# tokenizer base 4, 8 output channels
SMALL = dict(
    input_channels=1, num_classes=8, embed_dim=24, eva_depth=2,
    eva_numheads=2, patch_embed_size=(8, 8, 8), input_shape=(16, 16, 16),
    num_register_tokens=2, init_values=0.1, scale_attn_inner=True,
    qk_norm=True, out_norm="demean", out_norm_eps=1e-2,
    register_init_std=0.02, in_eps=1e-2, tokenizer_base_features=4,
)
# the PrimusV2 defaults the benchmark's configuration file states
DEFAULTS = dict(version="v2", tokenizer_depth_per_level=(1, 1, 1),
                mlp_ratio=4 * 2 / 3, rope_theta=100.0, use_rot_pos_emb=True,
                use_abs_pos_embed=True)
SEED = 2 ** 33 + 5


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def small():
    """(the port's config, the reference's config, the seeded weights)."""
    rcfg = dict(SMALL, **DEFAULTS)
    sd = synth_vit.vit_weights(ref_primus.parameter_shapes(rcfg), rcfg, SEED,
                               "cpu")
    return PrimusConfig(**SMALL), rcfg, sd


def _ref(rcfg, sd, vol):
    """The reference on a (B, D, H, W, 1) host window, NDHWC out."""
    x = torch.from_numpy(vol).permute(0, 4, 1, 2, 3)
    return ref_primus.forward(rcfg, sd, x).permute(0, 2, 3, 4, 1)


def test_parameter_shapes_are_the_ports(small):
    cfg, rcfg, sd = small
    port = {k: tuple(v.shape)
            for k, v in Primus(cfg, device="cpu").state_dict().items()}
    assert port == ref_primus.parameter_shapes(rcfg)
    # the defaults the configuration file states are the port's
    for key, value in DEFAULTS.items():
        assert getattr(cfg, key) == value, key


def test_port_window_forward_matches_reference(small):
    """Two windows through `Primus` (f32, the kernels' plain versions on
    the CPU) against the reference."""
    cfg, rcfg, sd = small
    vol = np.concatenate([synth.structured_volume((16, 16, 16), SEED, k,
                                                  "cpu") for k in range(2)])
    model = Primus.from_state_dict(cfg, sd, device="cpu")
    got = model(torch.from_numpy(vol), compute_dtype=torch.float32)
    ref = _ref(rcfg, sd, vol)
    assert got.shape == ref.shape == (2, 16, 16, 16, 8)
    assert _rel(got, ref) < TOL


def test_extractor_matches_reference_sliding(small):
    """`make_feature_extractor` on a 24x20x24 volume (windows of 16^3,
    overlap 0.8, Gaussian, two windows a batch) against the reference's
    `sliding_window`."""
    cfg, rcfg, sd = small
    vol = synth.structured_volume((24, 20, 24), SEED, 3, "cpu")
    got = make_feature_extractor(
        cfg, sd, sw_batch_size=2, overlap=0.8, sigma_scale=0.25,
        compute_dtype=torch.float32, device="cpu")(vol)
    x = torch.from_numpy(vol).permute(0, 4, 1, 2, 3)
    ref = ref_sliding.sliding_window(
        x, lambda v: ref_primus.forward(rcfg, sd, v), 8, (16, 16, 16), 0.8,
        0.25).permute(0, 2, 3, 4, 1)
    assert got.shape == ref.shape == (1, 24, 20, 24, 8)
    assert _rel(got, ref) < TOL


def test_reference_matches_jax_primus(small):
    """The reference against the JAX package's `primus_apply` (its XLA path
    on the CPU) on the same weights."""
    cfg, rcfg, sd = small
    vol = synth.structured_volume((16, 16, 16), SEED, 4, "cpu")
    jcfg = jax_primus.PrimusConfig(**SMALL)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    to_jax_primus_params(cfg, sd))
    want = jax_primus.primus_apply(jcfg, params, jnp.asarray(vol),
                                   compute_dtype=jnp.float32)
    ref = _ref(rcfg, sd, vol)
    assert ref.shape == want.shape
    assert _rel(ref, want) < JAX_TOL


def test_stated_precision_follows_the_ports_bf16_path(small):
    """The reference in the precision the benchmark's configuration states
    (q, k, v into attention and the decoder in bf16) is far closer to the
    port's bf16 window forward with the fold exit, the sliding path's, than
    the f32 reference is, and every part in bf16 is far from both."""
    cfg, rcfg, sd = small
    stated = json.loads((ROOT / "gpubench" / "configs"
                         / "anatomix-dev-vit.json").read_text())["precision"]
    vol = np.concatenate([synth.structured_volume((16, 16, 16), SEED, k,
                                                  "cpu") for k in range(2)])
    model = Primus.from_state_dict(cfg, sd, device="cpu")
    got = model(torch.from_numpy(vol), compute_dtype=torch.bfloat16,
                emit="fold")
    assert got.dtype == torch.bfloat16
    got = got.float().reshape(2, 16, 16, 16, 8).numpy()
    x = torch.from_numpy(vol).permute(0, 4, 1, 2, 3)

    def mean_err(precision):
        ref = ref_primus.forward(rcfg, sd, x, precision).permute(
            0, 2, 3, 4, 1).numpy().astype(np.float64)
        return np.abs(got - ref).mean() / ref.std()

    sound = mean_err(stated)
    assert 3 * sound < mean_err(None)
    assert 3 * sound < mean_err({p: "bfloat16" for p in ref_primus.PARTS})
    with pytest.raises(ValueError, match="unknown parts"):
        ref_primus.part_dtypes({"decoder_gemms": "bfloat16"})
