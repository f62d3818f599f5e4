"""Feature-extraction CLI of the port: volume(s) in, anatomix features out.

Usage (single volume):
  python -m anatomix_tpu_torch.extract_cli --input ct.nii.gz \
      --output feats.npz --hf_variant anatomix --cache_path anatomix.pth

Usage (the 94M dev UNet, instance-norm statistics per roi-sized tile):
  python -m anatomix_tpu_torch.extract_cli --input ct.nii.gz \
      --output feats.npz --hf_variant anatomix-dev \
      --cache_path anatomix-dev.pth --strategy full_tiled --normalize unit

Usage (the 26M ViT, always Gaussian-blended 128^3 sliding windows; the
`.npz` of the JAX pytree or the upstream `.pth`):
  python -m anatomix_tpu_torch.extract_cli --input ct.nii.gz \
      --output feats.npz --hf_variant anatomix-dev-vit \
      --cache_path anatomix-dev-vit.pth --normalize unit

Usage (dataset mode):
  python -m anatomix_tpu_torch.extract_cli --input_dir scans/ \
      --output_dir feats/ --ckpt_path anatomix.pth [--pattern '*.nii.gz']

The flags are those of `anatomix_tpu.extract_cli`, plus `--cache_path` (the
port downloads nothing) and `--device` (default `cuda`). Dataset mode
overlaps loading and writing with the card's work in two threads.
"""

from __future__ import annotations

import argparse
import glob
import os
import queue
import threading
import time

import numpy as np
import torch

from anatomix_tpu_torch.extract import (
    make_feature_extractor,
    minmax,
    unit_normalize,
    zscore_normalize,
)
from anatomix_tpu_torch.models.load import load_model
from anatomix_tpu_torch.utils.nifti import load_volume, save_volume


def build_parser():
    p = argparse.ArgumentParser(description="anatomix feature extraction")
    src_in = p.add_mutually_exclusive_group(required=True)
    src_in.add_argument("--input", type=str, default=None,
                        help=".nii/.nii.gz/.npy/.npz volume")
    src_in.add_argument("--input_dir", type=str, default=None,
                        help="directory of volumes (dataset mode)")
    p.add_argument("--output", type=str, default=None,
                   help="output .npz/.nii.gz (channel-last features)")
    p.add_argument("--output_dir", type=str, default=None,
                   help="output directory (dataset mode)")
    p.add_argument("--pattern", type=str, default="*.nii.gz",
                   help="glob for --input_dir")
    p.add_argument("--out_ext", type=str, default=".npz",
                   choices=[".npz", ".nii.gz"],
                   help="output format in dataset mode")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt_path", type=str, default=None)
    src.add_argument("--hf_variant", type=str, default=None)
    p.add_argument("--cache_path", type=str, default=None,
                   help="local .pth/.npz of --hf_variant")
    p.add_argument("--strategy", type=str, default="sliding",
                   choices=["sliding", "full", "full_tiled", "auto"],
                   help="UNets only; the ViT always slides")
    p.add_argument("--roi", type=int, default=128,
                   help="UNets only; the ViT's windows are its input shape")
    p.add_argument("--overlap", type=float, default=0.8)
    p.add_argument("--sw_batch_size", type=int, default=None,
                   help="windows per forward; default 2")
    p.add_argument("--minclip", type=float, default=None)
    p.add_argument("--maxclip", type=float, default=None)
    p.add_argument("--normalize", type=str, default="none",
                   choices=["none", "unit", "zscore"],
                   help="voxelwise feature normalization (dev models)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype; the card's kernels take bfloat16, "
                        "float32 runs on --device cpu")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--num_downs", type=int, default=4)
    p.add_argument("--ngf", type=int, default=16)
    p.add_argument("--output_nc", type=int, default=16)
    p.add_argument("--norm", type=str, default="batch")
    p.add_argument("--interp", type=str, default="nearest")
    p.add_argument("--pooling", type=str, default="Max")
    return p


def _load_one(path: str, args):
    vol, affine = load_volume(path)
    return minmax(vol, args.minclip, args.maxclip)[None, ..., None], affine


def _save_one(path: str, feats_np: np.ndarray, affine: np.ndarray) -> None:
    if path.endswith((".nii", ".nii.gz")):
        save_volume(path, feats_np, affine)
    else:
        np.savez(path, features=feats_np, affine=affine)


def _extract_one(extractor, x, args) -> np.ndarray:
    feats = extractor(x)
    if args.normalize == "unit":
        feats = unit_normalize(feats)
    elif args.normalize == "zscore":
        feats = zscore_normalize(feats)
    return feats[0].float().cpu().numpy()


def _run_dataset(extractor, args) -> int:
    """Loader thread -> card -> writer thread over --input_dir."""
    paths = sorted(glob.glob(os.path.join(args.input_dir, args.pattern)))
    if not paths:
        raise FileNotFoundError(
            f"no files match {args.pattern!r} in {args.input_dir}"
        )
    os.makedirs(args.output_dir, exist_ok=True)

    loaded: queue.Queue = queue.Queue(maxsize=2)  # bounds host memory
    to_write: queue.Queue = queue.Queue(maxsize=2)
    errors: list[BaseException] = []
    stop = threading.Event()

    def loader():
        try:
            for p in paths:
                if stop.is_set():
                    return
                loaded.put((p, _load_one(p, args)))
        except Exception as e:  # surfaced on the main thread
            errors.append(e)
        finally:
            loaded.put(None)

    def writer():
        try:
            while True:
                item = to_write.get()
                if item is None:
                    return
                _save_one(*item)
        except Exception as e:
            errors.append(e)

    lt = threading.Thread(target=loader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    lt.start()
    wt.start()

    n = 0
    t0 = time.time()
    try:
        while True:
            item = loaded.get()
            if item is None or errors:
                break
            path, (x, affine) = item
            feats_np = _extract_one(extractor, x, args)
            stem = os.path.basename(path)
            for ext in (".nii.gz", ".nii", ".npy", ".npz"):
                if stem.endswith(ext):
                    stem = stem[: -len(ext)]
                    break
            out = os.path.join(args.output_dir, stem + args.out_ext)
            to_write.put((out, feats_np, affine))
            n += 1
            print(f"[{n}/{len(paths)}] {path} -> {out} "
                  f"shape={feats_np.shape}")
    finally:
        stop.set()
        while lt.is_alive():  # drain so a blocked loader can finish
            try:
                loaded.get(timeout=0.1)
            except queue.Empty:
                pass
        to_write.put(None)
        wt.join()
        lt.join()
    if errors:
        raise errors[0]
    print(f"wrote {n} volumes in {time.time() - t0:.1f} s -> "
          f"{args.output_dir}")
    return n


def main(argv=None):
    args = build_parser().parse_args(argv)
    if (args.input_dir is None) != (args.output_dir is None):
        raise SystemExit("--input_dir and --output_dir go together")
    if args.input is not None and args.output is None:
        raise SystemExit("--input requires --output")
    plan, state_dict = load_model(
        ckpt_path=args.ckpt_path, hf_variant=args.hf_variant,
        cache_path=args.cache_path, num_downs=args.num_downs, ngf=args.ngf,
        output_nc=args.output_nc, norm=args.norm, interp=args.interp,
        pooling=args.pooling, device=args.device,
    )
    extractor = make_feature_extractor(
        plan, state_dict,
        strategy=args.strategy,
        roi_size=(args.roi,) * 3,
        overlap=args.overlap,
        sw_batch_size=args.sw_batch_size,
        compute_dtype=(
            torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
        ),
        device=args.device,
    )
    if args.input_dir is not None:
        _run_dataset(extractor, args)
        return
    x, affine = _load_one(args.input, args)
    feats_np = _extract_one(extractor, x, args)
    _save_one(args.output, feats_np, affine)
    print(f"wrote {args.output} shape={feats_np.shape}")


if __name__ == "__main__":
    main()
