"""The port's `models/convert_cli.py` against the JAX package's on the same
seeded `.pth` files: the `.npz` each writes holds the same arrays under the
same keys, bit for bit, for the `anatomix` variant, custom flags (a
`module.` prefix, an instance-norm model, PReLU, a 2-D model) and the ViT
variant (a seeded full-config upstream state dict). The JAX package's round trip reads the
port's file. No test here reads a reference checkout."""


import numpy as np
import pytest
import torch

from anatomix_tpu.models import convert_cli as jax_cli
from anatomix_tpu.models.load import load_model as jax_load_model
from anatomix_tpu_torch.models import convert_cli
from anatomix_tpu_torch.models.load import load_model
from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.models.vit3d import primus_config


def _equal_npz(got_path, ref_path):
    with np.load(got_path) as got, np.load(ref_path) as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        return len(ref.files)


def _both(tmp_path, sd, argv):
    src = str(tmp_path / "m.pth")
    torch.save(sd, src)
    got, ref = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    convert_cli.main([src, got] + argv)
    jax_cli.main([src, ref] + argv)
    return got, ref


@pytest.mark.parametrize("argv,config,prefix", [
    (["--variant", "anatomix"], ANATOMIX_VARIANTS["anatomix"]["unet_kwargs"],
     ""),
    (["--num_downs", "2", "--ngf", "4", "--output_nc", "4"],
     dict(num_downs=2, ngf=4, output_nc=4), "module."),
    (["--num_downs", "3", "--ngf", "4", "--output_nc", "8", "--norm",
      "instance", "--pooling", "Avg", "--interp", "trilinear",
      "--norm_eps", "0.01"],
     dict(num_downs=3, ngf=4, output_nc=8, norm="instance", pooling="Avg",
          interp="trilinear", norm_eps=0.01), ""),
])
def test_unet_npz_equals_jax(tmp_path, argv, config, prefix):
    plan = build_plan(UnetConfig(**config))
    sd = {prefix + k: v for k, v in init_params(
        plan, torch.Generator().manual_seed(1)).items()}
    got, ref = _both(tmp_path, sd, argv)
    assert _equal_npz(got, ref) > 0
    # both loaders read the port's file: the JAX package's, and the port's
    kw = dict(num_downs=config["num_downs"], ngf=config["ngf"],
              output_nc=config["output_nc"],
              norm=config.get("norm", "batch"),
              interp=config.get("interp", "nearest"),
              pooling=config.get("pooling", "Max"))
    _, jparams = jax_load_model(ckpt_path=got, **kw)
    with np.load(got) as flat:
        assert sum(len(sub) for sub in jparams.values()) == len(flat.files)
        for idx, sub in jparams.items():
            for leaf, v in sub.items():
                np.testing.assert_array_equal(np.asarray(v),
                                              flat[f"{idx}/{leaf}"])
    _, back = load_model(ckpt_path=got, device="cpu", **kw)
    for k, v in sd.items():
        if v.is_floating_point():
            torch.testing.assert_close(back[k[len(prefix):]], v, rtol=0,
                                       atol=0)


def test_vit_npz_equals_jax(tmp_path):
    """The full 26M config (embed 396, 12 blocks) from a seeded
    upstream-layout state dict."""
    from test_torch_vit import _upstream_state_dict

    cfg = primus_config(ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"])
    sd = _upstream_state_dict(cfg, np.random.default_rng(2))
    got, ref = _both(tmp_path, sd, ["--variant", "anatomix-dev-vit"])
    assert _equal_npz(got, ref) > 100


@pytest.mark.parametrize("argv,config", [
    (["--activation", "prelu", "--num_downs", "2", "--ngf", "4",
      "--output_nc", "4"],
     dict(activation="prelu", num_downs=2, ngf=4, output_nc=4)),
    (["--dimension", "2", "--num_downs", "2", "--ngf", "4", "--output_nc",
      "4"], dict(dimension=2, num_downs=2, ngf=4, output_nc=4)),
])
def test_prelu_and_2d_options_convert(tmp_path, argv, config):
    """A PReLU model (the shared weight at every act slot of the `.pth`,
    one `prelu/w` in the `.npz`) and a 2-D model (`nn.Conv2d` weights,
    degenerate-3-D DHWIO in the `.npz`) convert, and the file equals the
    JAX package's `convert_cli` output bit for bit."""
    plan = build_plan(UnetConfig(**config))
    sd = init_params(plan, torch.Generator().manual_seed(2))
    sd = {k: (torch.full_like(v, 0.37) if v.shape == (1,) else v)
          for k, v in sd.items()}
    got, ref = _both(tmp_path, sd, argv)
    assert _equal_npz(got, ref) > 0
    with np.load(got) as flat:
        if config.get("activation") == "prelu":
            np.testing.assert_array_equal(flat["prelu/w"],
                                          np.float32([0.37]))
        else:
            assert flat["0/w"].shape == (1, 3, 3, 1, 4)
