"""Tutorial 1 on the port: 3D feature extraction and training-free
multimodal registration (the counterpart of the JAX package's
`examples/feature_extraction_and_registration.py`).

Builds a synthetic "multimodal" pair the way the pretraining data is made
(one shared anatomy of labelled spheres, two GMM appearance draws), deforms
one of them by a known smooth field, extracts anatomix features of both,
registers them with anatomix features + MIND through the ConvexAdam-style
solver and reports the label Dice before and after.

With the default tiny random-init backbone, on the card or on the CPU:

    python -m anatomix_tpu_torch.examples.feature_extraction_and_registration
    python -m anatomix_tpu_torch.examples.feature_extraction_and_registration \
        --device cpu --size 32 --niter 8

With real weights (a local `.pth` or `.npz`; nothing is downloaded):

    python -m anatomix_tpu_torch.examples.feature_extraction_and_registration \
        --ckpt anatomix.pth --size 128
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def build_pair(size: int, seed: int = 0, device="cpu"):
    """Shared anatomy, two GMM appearances, one known smooth deformation:
    (fixed image, fixed labels, moving image, moving labels) as numpy."""
    from anatomix_tpu_torch.registration.warp import warp_volume
    from anatomix_tpu_torch.synthgen.core import (
        draw_perlin_deformation,
        generate_voxel_sphere,
        sample_gmm,
    )

    rng = np.random.default_rng(seed)
    labels = np.zeros((size,) * 3, np.uint8)
    for k in range(1, 7):
        radius = int(size * rng.uniform(0.08, 0.18))
        center = rng.integers(radius + 2, size - radius - 2, 3)
        sphere = generate_voxel_sphere(radius, (size,) * 3,
                                       center_shift=center - size // 2)
        labels[sphere > 0] = k

    # two appearances of the same anatomy: a synthetic multimodal pair
    n_lab = len(np.unique(labels))
    view1 = sample_gmm(rng.uniform(25, 255, n_lab), rng.uniform(5, 20, n_lab),
                       labels, zero_bckgnd=0.0, rng=rng)
    view2 = sample_gmm(rng.uniform(25, 255, n_lab), rng.uniform(5, 20, n_lab),
                       labels, zero_bckgnd=0.0, rng=rng)

    # a known smooth deformation of view2 and its labels: the moving pair
    field = draw_perlin_deformation((3, size, size, size),
                                    scales=[size // 8, size // 4],
                                    max_std=2.5, rng=rng)
    disp = torch.from_numpy(np.moveaxis(field, 0, -1).astype(np.float32))[
        None].to(device)  # (1, D, H, W, 3) voxels

    def warp(vol, mode):
        v = torch.from_numpy(np.asarray(vol, np.float32))[None, ..., None]
        return warp_volume(v.to(device), disp, mode=mode)[0, ..., 0].cpu()

    moving = warp(view2, "bilinear").numpy()
    moving_seg = warp(labels, "nearest").numpy().astype(np.uint8)
    return view1.astype(np.float32), labels, moving, moving_seg


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--ckpt", type=str, default=None,
                    help="local .pth or .npz checkpoint")
    ap.add_argument("--hf-variant", type=str, default=None)
    ap.add_argument("--cache-path", type=str, default=None,
                    help="local .pth/.npz of --hf-variant")
    ap.add_argument("--ngf", type=int, default=4,
                    help="width of the random-init demo backbone")
    ap.add_argument("--num-downs", type=int, default=2)
    ap.add_argument("--niter", type=int, default=30,
                    help="Adam instance-opt iterations (reference: 80)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    return ap


def main(argv=None):
    from anatomix_tpu_torch.device import resolve_device
    from anatomix_tpu_torch.extract import extract_features
    from anatomix_tpu_torch.models.load import load_model
    from anatomix_tpu_torch.models.unet import (
        UnetConfig,
        build_plan,
        init_params,
    )
    from anatomix_tpu_torch.registration.pipeline import (
        macro_dice,
        register_pair,
    )
    from anatomix_tpu_torch.registration.warp import warp_volume

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    fixed, fixed_seg, moving, moving_seg = build_pair(args.size, device=dev)
    print(f"synthetic pair built: {fixed.shape}, "
          f"{int(fixed_seg.max())} labels")

    # ---- model ------------------------------------------------------------
    if args.ckpt or args.hf_variant:
        plan, sd = load_model(ckpt_path=args.ckpt,
                              hf_variant=args.hf_variant,
                              cache_path=args.cache_path, device=dev)
    else:
        plan = build_plan(UnetConfig(
            dimension=3, input_nc=1, output_nc=args.ngf,
            num_downs=args.num_downs, ngf=args.ngf))
        sd = {k: v.to(dev) for k, v in init_params(
            plan, torch.Generator().manual_seed(0)).items()}
        print("using a RANDOM-INIT demo backbone: pass --ckpt for real "
              "anatomix features")

    # ---- feature extraction (tutorial part 1) -----------------------------
    roi = min(args.size, 128)
    cd = torch.float32 if dev.type == "cpu" else torch.bfloat16
    feats_fixed, feats_moving = extract_features(
        fixed, moving, plan, sd, strategy="auto", roi_size=(roi,) * 3,
        compute_dtype=cd, device=dev)
    print(f"features: {tuple(feats_fixed.shape)} (voxel-wise "
          f"{feats_fixed.shape[-1]}-d descriptors)")

    # ---- registration (tutorial part 2) ------------------------------------
    t0 = time.time()
    disp, solver_s = register_pair(
        fixed, moving, plan, sd, grid_sp=2, disp_hw=1,
        selected_niter=args.niter, grid_sp_adam=2, ic=True,
        extract_strategy="auto", device=dev)
    print(f"registration done in {time.time() - t0:.1f}s wall "
          f"(solver {solver_s:.2f}s)")
    seg = torch.from_numpy(moving_seg.astype(np.float32))[None, ..., None]
    moved_seg = warp_volume(seg.to(dev), disp, mode="nearest")[
        0, ..., 0].cpu().numpy().astype(np.uint8)

    d_before = macro_dice(fixed_seg, moving_seg)
    d_after = macro_dice(fixed_seg, moved_seg)
    print(f"label Dice before: {d_before:.3f}  after: {d_after:.3f}")
    if not d_after > d_before:
        raise RuntimeError("registration should improve alignment")
    print("OK")
    return d_before, d_after


if __name__ == "__main__":
    main()
