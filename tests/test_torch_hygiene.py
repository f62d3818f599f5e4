"""Hygiene of the port: it imports neither JAX nor the JAX package (nor, at
module import, h5py, matplotlib or TensorBoard, which the loop loads only
when it uses them), its entry points refuse to run on a missing card, and
the card-only tests are marked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import anatomix_tpu_torch
names = ["anatomix_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(
        anatomix_tpu_torch.__path__, "anatomix_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
lazy = ("h5py", "matplotlib", "tensorboard", "torch.utils.tensorboard")
bad = sorted(m for m in sys.modules
             if m in ("jax", "optax", "flax") + lazy
             or m.startswith(("jax.", "jaxlib", "optax.", "flax."))
             or m.startswith(tuple(n + "." for n in lazy))
             or m == "anatomix_tpu" or m.startswith("anatomix_tpu."))
print(len(names))
print(bad)
"""


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter (the test
    process itself has JAX loaded by conftest)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120, check=True,
    ).stdout.splitlines()
    assert int(out[0]) >= 40
    assert out[1] == "[]"


def test_pretraining_package_is_lazy():
    """Importing `anatomix_tpu_torch.pretraining` loads none of its
    modules, and nothing of JAX, optax, flax or h5py."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys, anatomix_tpu_torch.pretraining as p\n"
            "print(sorted(m for m in sys.modules if m.startswith("
            "('anatomix_tpu_torch.pretraining.', 'jax', 'optax', 'flax', "
            "'h5py', 'matplotlib', 'tensorboard', 'anatomix_tpu.'))))\n"
            "print(p.build_all.__module__)")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120, check=True,
    ).stdout.splitlines()
    assert out == ["[]", "anatomix_tpu_torch.pretraining.train"]


def test_registration_imports_no_jax():
    """`anatomix_tpu_torch.registration` and the ops it brought (the EDT)
    are in the walk above, and importing the package loads nothing of JAX,
    optax or the JAX package."""
    import pkgutil

    import anatomix_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        anatomix_tpu_torch.__path__, "anatomix_tpu_torch.")}
    want = {f"anatomix_tpu_torch.registration.{m}" for m in (
        "cli", "correlate", "merge", "mind", "pipeline", "solver", "warp")}
    assert want | {"anatomix_tpu_torch.registration",
                   "anatomix_tpu_torch.ops.edt"} <= names
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys, anatomix_tpu_torch as p\n"
            "r = p.registration\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'flax', 'anatomix_tpu')))\n"
            "print(len(r.__all__))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120, check=True,
    ).stdout.splitlines()
    assert out == ["[]", "23"]


def test_registration_raises_without_cuda(monkeypatch, tmp_path):
    """`register_pair`, `convex_adam` and the CLI default to the card:
    with none they raise before reading or writing anything."""
    from anatomix_tpu_torch.registration.cli import build_parser, main
    from anatomix_tpu_torch.registration.pipeline import register_pair

    argv = ["--fixed", str(tmp_path / "missing_f.nii.gz"),
            "--moving", str(tmp_path / "missing_m.nii.gz"),
            "--exp_name", "x", "--ckpt_path", str(tmp_path / "missing.pth"),
            "--result_path", str(tmp_path / "out")]
    assert build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert not (tmp_path / "out").exists()
    # the volumes, the plan and the weights are never touched
    with pytest.raises(RuntimeError, match="device='cpu'"):
        register_pair(None, None, None, None)


def test_segmentation_convert_cli_and_synthgen_import_no_jax():
    """The segmentation package, `models/convert_cli` and `synthgen` are in
    the walk above; importing them loads nothing of JAX, optax, the JAX
    package or h5py (step 3 imports it when it runs)."""
    import pkgutil

    import anatomix_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        anatomix_tpu_torch.__path__, "anatomix_tpu_torch.")}
    want = {f"anatomix_tpu_torch.segmentation.{m}" for m in (
        "data", "losses", "model", "transforms", "train")}
    want |= {f"anatomix_tpu_torch.synthgen.{m}" for m in (
        "core", "transforms_np", "pipeline")}
    assert want | {"anatomix_tpu_torch.models.convert_cli"} <= names
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys, anatomix_tpu_torch as p\n"
            "s, g = p.segmentation, p.synthgen\n"
            "import anatomix_tpu_torch.segmentation.train\n"
            "import anatomix_tpu_torch.models.convert_cli\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'flax', 'anatomix_tpu', 'h5py')))\n"
            "print(len(s.__all__), len(g.__all__))")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120, check=True,
    ).stdout.splitlines()
    assert out == ["[]", "13 23"]


def test_segmentation_raises_without_cuda(monkeypatch, tmp_path):
    """`load_seg_model` and the finetuning CLI default to the card: with
    none they raise `resolve_device`'s error before reading or writing
    anything (the checkpoint and the dataset here do not exist)."""
    from anatomix_tpu_torch.segmentation.model import load_seg_model
    from anatomix_tpu_torch.segmentation.train import build_parser, main

    argv = ["--exp_name", "x", "--dataset", str(tmp_path / "missing"),
            "--n_classes", "2", "--pretrained_ckpt",
            str(tmp_path / "missing.pth")]
    assert build_parser().parse_args(argv).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_seg_model(2, ckpt_path=str(tmp_path / "missing.pth"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(build_parser().parse_args(argv))
    assert not (tmp_path / "finetuning_runs").exists()


def test_primus_raises_without_cuda(monkeypatch):
    """`Primus` and `Primus.from_state_dict` default to the card and raise
    without one, as `resolve_device` does; a device the caller names
    passes as given (the CPU, and `meta`, which `resolve_device` would
    refuse)."""
    from anatomix_tpu_torch.models.vit3d import (
        Primus,
        PrimusConfig,
        init_primus_params,
    )

    cfg = PrimusConfig(embed_dim=16, eva_depth=1, eva_numheads=2,
                       input_shape=(16, 16, 16), num_register_tokens=1,
                       tokenizer_base_features=4)
    sd = init_primus_params(cfg, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Primus.from_state_dict(cfg, sd)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Primus(cfg)
    model = Primus.from_state_dict(cfg, sd, device="cpu")
    assert model.pos_embed.device.type == "cpu"
    assert Primus(cfg, device="meta").pos_embed.device.type == "meta"


def test_load_from_hf_at_the_top_level():
    """`anatomix_tpu_torch.load_from_hf` is `models.load.load_from_hf`, as
    the JAX package re-exports its own."""
    import anatomix_tpu_torch
    from anatomix_tpu_torch.models import load

    assert anatomix_tpu_torch.load_from_hf is load.load_from_hf
    assert "load_from_hf" in dir(anatomix_tpu_torch)


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert "anatomix_tpu_torch.extract" in mods
    for m in mods:
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib", "anatomix_tpu", "optax", "flax",
                           "h5py"), m


def test_entry_points_raise_without_cuda(monkeypatch):
    from anatomix_tpu_torch.extract import make_feature_extractor
    from anatomix_tpu_torch.models.load import load_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("scratch", allow_scratch=True, num_downs=2, ngf=8)
    plan, sd = load_model("scratch", allow_scratch=True, num_downs=2, ngf=8,
                          device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        make_feature_extractor(plan, sd, strategy="full")
    # the CPU is used only when asked for
    feats = make_feature_extractor(plan, sd, strategy="full", device="cpu")(
        np.zeros((1, 8, 8, 8, 1), np.float32))
    assert feats.device.type == "cpu"
    # the ViT: its loader and its extractor default to the card as well
    from anatomix_tpu_torch.models.load import load_from_hf
    from anatomix_tpu_torch.models.vit3d import (
        PrimusConfig,
        init_primus_params,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_from_hf("anatomix-dev-vit", "vit.npz")
    cfg = PrimusConfig(embed_dim=16, eva_depth=1, eva_numheads=2,
                       input_shape=(16, 16, 16), num_register_tokens=1,
                       tokenizer_base_features=4)
    vsd = init_primus_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="is_available"):
        make_feature_extractor(cfg, vsd)
    feats = make_feature_extractor(cfg, vsd, device="cpu",
                                   compute_dtype=torch.float32)(
        np.zeros((1, 16, 16, 16, 1), np.float32))
    assert feats.shape == (1, 16, 16, 16, 32) and feats.device.type == "cpu"


def test_build_all_raises_without_cuda(monkeypatch, tmp_path):
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all
    from anatomix_tpu_torch.pretraining.train_step import init_train_state
    from anatomix_tpu_torch.utils.checkpoint import (
        load_train_state,
        save_train_state,
    )

    cfg = PretrainConfig(ngf=4, num_downs=2, nce_layers=(17, 37),
                         netF_nc=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_all(cfg, 1)
    # the ViT's pretraining step too: on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_all(PretrainConfig(netG="primus"), 1)
    vplan, _, vstate, _ = build_all(
        PretrainConfig(netG="primus", crop_size=16, netF_nc=8), 1,
        device="cpu")
    assert vplan.input_shape == (16, 16, 16)
    assert all(v.device.type == "cpu" for v in vstate.params_g.values())
    # the CPU is used only when asked for
    plan, taps, state, _ = build_all(cfg, 1, device="cpu")
    assert state.params_g["model.0.weight"].device.type == "cpu"
    # the state builders behind the step default to the card too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(plan, torch.Generator().manual_seed(0),
                         tap_layers=taps, netf_nc=8)
    path = str(tmp_path / "state.npz")
    save_train_state(path, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_train_state(path)
    back = load_train_state(path, device="cpu")
    assert back.params_g["model.0.weight"].device.type == "cpu"


def test_train_raises_without_cuda(monkeypatch, tmp_path):
    """The trainer and its CLI default to the card: with none, `train`
    raises `resolve_device`'s error before it writes anything."""
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_parser, train

    assert build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PretrainConfig(ckpt_dir=str(tmp_path / "ckpt"),
                         dataroot=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)
    assert not (tmp_path / "ckpt").exists()


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    from anatomix_tpu_torch.extract_cli import build_parser, main

    assert build_parser().parse_args(
        ["--input", "x", "--ckpt_path", "y"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    np.save(tmp_path / "v.npy", np.zeros((8, 8, 8), np.float32))
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--input", str(tmp_path / "v.npy"), "--output",
              str(tmp_path / "o.npz"), "--ckpt_path", "scratch"])


def test_gpu_marker_registered():
    ini = open(os.path.join(ROOT, "pytest.ini")).read()
    assert "gpu:" in ini
