"""Tutorial 3 on the port: synthesize training data and pretrain anatomix
(the reference's `generate_training_data.sh` + `pretrain_anatomix.py`
recipe end to end at toy scale; the counterpart of the JAX package's
`examples/synthgen_and_pretraining.py`).

1. Makes a handful of organ "templates" (random blobs as NIfTIs; in the
   real recipe these are TotalSegmentator labelmaps after step 0).
2. Runs the port's synthesis pipeline: label ensembles -> paired GMM +
   corruption views -> HDF5 (`anatomix_tpu_torch.synthgen.pipeline`,
   steps 1-3, in two spawned worker processes).
3. Runs a short supervised-PatchNCE pretraining with the port's trainer
   (`--max_iters`, the reference's smoke-test knob) and resumes it once
   to show the exact-iteration checkpoint resume.

On the card or on the CPU:

    python -m anatomix_tpu_torch.examples.synthgen_and_pretraining
    python -m anatomix_tpu_torch.examples.synthgen_and_pretraining \
        --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np


def make_templates(template_dir: str, n: int, size: int, seed: int = 0):
    from anatomix_tpu_torch.synthgen.core import generate_voxel_sphere
    from anatomix_tpu_torch.utils.nifti import save_volume

    rng = np.random.default_rng(seed)
    os.makedirs(template_dir, exist_ok=True)
    for i in range(n):
        radius = int(size * rng.uniform(0.15, 0.3))
        center = rng.integers(radius + 1, size - radius - 1, 3)
        vol = generate_voxel_sphere(radius, (size,) * 3,
                                    center_shift=center - size // 2)
        save_volume(os.path.join(template_dir, f"organ{i:02d}.nii.gz"),
                    vol.astype(np.float32))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=32,
                    help="synthesized volume sidelength (reference: 128)")
    ap.add_argument("--n-vols", type=int, default=6)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def main(argv=None):
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import train
    from anatomix_tpu_torch.synthgen.pipeline import generate_training_data

    args = build_parser().parse_args(argv)
    print(f"device: {args.device}")
    root = args.workdir or tempfile.mkdtemp(prefix="anatomix_pretrain_")

    # ---- 1+2: synthesize paired training data -> HDF5 ---------------------
    template_dir = os.path.join(root, "templates")
    make_templates(template_dir, n=5, size=args.size)
    train_h5 = generate_training_data(
        template_dir, os.path.join(root, "synth"), args.n_vols,
        val_count=2, sidelen=args.size, max_workers=2, seed=0)
    print(f"training data: {train_h5}")

    # ---- 3: pretraining smoke + exact-iteration resume ---------------------
    cfg = PretrainConfig(
        name="pretrain_demo",
        dataroot=os.path.dirname(train_h5),
        ckpt_dir=os.path.join(root, "checkpoints"),
        crop_size=args.size,
        batch_size=1,
        ngf=4,
        num_downs=2,
        netF_nc=16,
        num_patches=32,
        nce_layers=(5, 8),  # taps valid for the 2-down toy net
        max_iters=args.iters,
        print_freq=2,
        save_latest_freq=4,
        evaluation_freq=4,
        n_val_during_train=1,
    )
    state = train(cfg, device=args.device)
    print(f"smoke training done (max_iters={cfg.max_iters})")

    cfg_resume = dataclasses.replace(cfg, continue_train=True,
                                     max_iters=args.iters * 2)
    resumed = train(cfg_resume, device=args.device)
    print("resume from latest checkpoint OK")
    print("run dir:", os.path.join(cfg.ckpt_dir, cfg.name))
    print("OK")
    return state, resumed


if __name__ == "__main__":
    main()
