"""The port's tutorials (`anatomix_tpu_torch/examples/`) run on the CPU at
tiny sizes, the flags `tests/test_examples.py` gives the JAX package's
scripts, plus `--device cpu`; each calls its module's `main` in this
process and checks what it printed and wrote."""

import os

import pytest

from anatomix_tpu_torch.examples import (
    feature_extraction_and_registration as reg_example,
)
from anatomix_tpu_torch.examples import fewshot_segmentation as seg_example
from anatomix_tpu_torch.examples import (
    synthgen_and_pretraining as pretrain_example,
)


def test_registration_tutorial(capsys):
    """The synthetic pair registers: the label Dice rises."""
    before, after = reg_example.main(["--size", "32", "--niter", "8",
                                      "--device", "cpu"])
    assert after > before
    assert "OK" in capsys.readouterr().out


def test_fewshot_tutorial(tmp_path, monkeypatch, capsys):
    """The synthetic NIfTI set finetunes through the port's CLI for one
    epoch with validation: the best and epoch checkpoints exist."""
    monkeypatch.chdir(tmp_path)  # the script chdirs into its workdir
    root = seg_example.main(["--size", "32", "--crop", "16", "--epochs",
                             "1", "--workdir", str(tmp_path / "w"),
                             "--device", "cpu"])
    ckpt = os.path.join(root, "finetuning_runs", "checkpoints",
                        "fewshot_demo")
    names = os.listdir(ckpt)
    assert "epoch0001.npz" in names
    assert any(n.startswith("best_dict_epoch") for n in names)
    assert "OK" in capsys.readouterr().out


def test_synthgen_pretraining_tutorial(tmp_path, capsys):
    """Templates -> label ensembles -> paired views -> HDF5 -> 2 trainer
    steps, then the resume runs on to 4 from the saved state."""
    state, resumed = pretrain_example.main(
        ["--size", "32", "--n-vols", "3", "--iters", "2", "--workdir",
         str(tmp_path), "--device", "cpu"])
    assert state.step == 2 and resumed.step == 4
    assert resumed.opt_state_g["count"] == 4
    assert os.path.exists(tmp_path / "synth" / "h5_w_segs"
                          / "train_data.hdf5")
    assert "OK" in capsys.readouterr().out


@pytest.mark.parametrize("module", [reg_example, seg_example,
                                    pretrain_example])
def test_tutorials_default_to_the_card(module):
    """Each tutorial's `--device` defaults to `cuda`, as the port's entry
    points do."""
    assert module.build_parser().parse_args([]).device == "cuda"
