"""Synthetic-data pipeline steps 0–3 (offline, process-pool parallel).

The port's copy of `anatomix_tpu/synthgen/pipeline.py`, mirroring the
reference's `synthetic-data-generation/`:
  step0: TotalSegmentator preprocess (merge per-rib/per-vertebra labels,
         drop blanks) — `step0_preprocess_totalsegmentator.py`
  step1: random label ensembles (20–40 affine-transformed organ templates,
         optional Perlin-deformed-sphere foreground mask + morphological
         envelope shell) — `step1_generate_labels.py`
  step2: paired contrastive views (two GMM draws × Perlin texture ×
         corruption chain), saved uint8 — `step2_generate_views.py`
  step3: HDF5 packing ((2, s, s, s) img + seg per group, train/val split)
         — `step3_generate_h5_w_segs.py`
"""

from __future__ import annotations

import multiprocessing
import os
import random
import string
from concurrent.futures import ProcessPoolExecutor
from glob import glob

import numpy as np

from anatomix_tpu_torch.synthgen.core import (
    apply_random_affine_transform,
    ball,
    crop_and_pad_3d_volume,
    dilation,
    draw_perlin,
    erosion,
    median_filter_labels,
    sample_corruption,
    sample_gmm,
    transform_uniform,
)
from anatomix_tpu_torch.synthgen.transforms_np import view_corruption_chain
from anatomix_tpu_torch.utils.nifti import load_volume, save_volume


def _pool(max_workers):
    # spawned workers: a forked copy of a process that has started threads
    # (torch's) is unsafe
    return ProcessPoolExecutor(
        max_workers=max_workers,
        mp_context=multiprocessing.get_context("spawn"))


# -----------------------------------------------------------------------------
# step 0 — TotalSegmentator preprocess

RIB_PREFIX = "rib_"
VERT_PREFIX = "vertebrae_"


def merge_vertebrae_and_ribs(subject_dir: str, out_dir: str) -> int:
    """Merge per-rib / per-vertebra files into all_ribs / all_vertebrae and
    copy non-blank organ labels (`step0_preprocess_totalsegmentator.py:
    13-179`). Returns number of labels written."""
    os.makedirs(out_dir, exist_ok=True)
    seg_files = sorted(glob(os.path.join(subject_dir, "*.nii.gz"))) + sorted(
        glob(os.path.join(subject_dir, "*.npz"))
    )
    written = 0
    merged = {"all_ribs": None, "all_vertebrae": None}
    affine = np.eye(4)
    for path in seg_files:
        name = os.path.basename(path)
        if name.startswith("ct") or name.startswith("CT"):
            continue  # CT intensities are not used by the synthesis
        data, affine = load_volume(path)
        if data.sum() == 0:
            continue
        if name.startswith(RIB_PREFIX):
            key = "all_ribs"
        elif name.startswith(VERT_PREFIX):
            key = "all_vertebrae"
        else:
            save_volume(os.path.join(out_dir, name), data.astype(np.uint8),
                        affine)
            written += 1
            continue
        merged[key] = (
            data if merged[key] is None else np.maximum(merged[key], data)
        )
    for key, data in merged.items():
        if data is not None:
            save_volume(
                os.path.join(out_dir, f"{key}.nii.gz"),
                data.astype(np.uint8), affine,
            )
            written += 1
    return written


# -----------------------------------------------------------------------------
# step 1 — label ensembles

def generate_label_ensemble(
    segs,
    idx: int,
    min_shapes: int,
    max_shapes: int,
    savedir: str,
    sidelen: int = 128,
    seed: int | None = None,
) -> str:
    """One random label ensemble (`step1_generate_labels.py:26-165`)."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    identifier = "unconstrained"
    n_templates = int(rng.integers(min_shapes, max_shapes))
    ensemble = np.zeros((sidelen,) * 3, np.uint8)

    for k in range(n_templates):
        template = np.zeros(1)
        tries = 0
        while template.sum() == 0 and tries < 50:
            template, _ = load_volume(str(rng.choice(segs)))
            template = template.astype(np.uint8)
            tries += 1
        crop = crop_and_pad_3d_volume(template, (sidelen,) * 3)
        crop = apply_random_affine_transform(
            crop, mode="grid-wrap", rng=rng
        )
        roi = crop[:sidelen, :sidelen, :sidelen]
        ensemble[roi > 0] = k * 1  # reference semantics (k, incl. k=0)

    ensemble = median_filter_labels(ensemble)

    if rng.random() > 0.33333:
        identifier = "foreground_masked"
        sphere = 1.0 - sample_corruption(
            (sidelen,) * 3, max_std=5.0, rng=rng
        )
        sphere = median_filter_labels(sphere.astype(np.uint8))
        ensemble = (sphere * ensemble).astype(np.uint8)
        ensemble[sphere > 0] += 1

        if rng.random() > 0.5:
            identifier = "foreground_masked_enveloped"
            kern = int(rng.choice([2, 3, 4]))
            fp = ball(kern)
            dil = dilation(sphere > 0, fp)
            ero = erosion(sphere > 0, fp)
            envelope = np.logical_and(dil, ~ero)
            ensemble[envelope] = 1 + ensemble.max()

    randstr = "".join(
        pyrng.choices(string.ascii_uppercase + string.digits, k=7)
    )
    fpath = os.path.join(
        savedir, f"{identifier}_shapes{n_templates}_{randstr}.nii.gz"
    )
    while os.path.isfile(fpath):
        randstr = "".join(
            pyrng.choices(string.ascii_uppercase + string.digits, k=7)
        )
        fpath = os.path.join(
            savedir, f"{identifier}_shapes{n_templates}_{randstr}.nii.gz"
        )
    save_volume(fpath, ensemble.astype(np.uint8), np.eye(4))
    return fpath


def run_step1(
    segs, n_vols, savedir, min_shapes=20, max_shapes=40, sidelen=128,
    max_workers=None, base_seed=0,
):
    os.makedirs(savedir, exist_ok=True)
    args = [
        (segs, i, min_shapes, max_shapes, savedir, sidelen, base_seed + i)
        for i in range(n_vols)
    ]
    if max_workers == 0:
        return [generate_label_ensemble(*a) for a in args]
    with _pool(max_workers) as pool:
        return list(pool.map(_step1_worker, args))


def _step1_worker(args):
    return generate_label_ensemble(*args)


# -----------------------------------------------------------------------------
# step 2 — paired views

def process_volume(
    lab_path: str,
    savedir: str,
    seed: int,
    means_range=(25, 255),
    stds_range=(5, 20),
    perl_scales=(4, 8, 16, 32),
    perl_max_std: float = 5.0,
    perl_mult_factor: float = 0.02,
):
    """Two corruption-augmented GMM views of one label ensemble
    (`step2_generate_views.py:22-143`)."""
    rng = np.random.default_rng(seed)
    label, _ = load_volume(lab_path)
    labels = np.unique(label)
    shape = label.shape

    views = []
    for _ in range(2):
        means = transform_uniform(rng.random(len(labels)), *means_range)
        stds = transform_uniform(rng.random(len(labels)), *stds_range)
        synth = sample_gmm(means, stds, label, rng=rng)
        perl = draw_perlin(shape, perl_scales, 0.0, perl_max_std, rng)
        textured = synth * (1 + perl_mult_factor * perl)
        views.append(view_corruption_chain(textured, rng))

    base = os.path.basename(lab_path)
    for v, view in enumerate(views, start=1):
        out_dir = os.path.join(savedir, f"view{v}")
        os.makedirs(out_dir, exist_ok=True)
        save_volume(
            os.path.join(out_dir, f"view{v}_{base}"),
            (view * 255.0).astype(np.uint8),
            np.eye(4),
        )


def run_step2(label_paths, savedir, max_workers=None, base_seed=0, **kw):
    os.makedirs(savedir, exist_ok=True)
    args = [
        (lab, savedir, base_seed + i) for i, lab in enumerate(label_paths)
    ]
    if max_workers == 0:
        for a in args:
            process_volume(*a, **kw)
        return
    with _pool(max_workers) as pool:
        list(pool.map(_step2_worker, [(a, kw) for a in args]))


def _step2_worker(packed):
    args, kw = packed
    process_volume(*args, **kw)


# -----------------------------------------------------------------------------
# step 3 — HDF5 packing

def run_step3(
    views_dir: str,
    labels_dir: str,
    out_dir: str,
    val_count: int = 0,
):
    """Pack (view1, view2) -> img (2, s, s, s) + seg per '{:06d}' group into
    train_data.hdf5 / val_data.hdf5 (`step3_generate_h5_w_segs.py:8-125`)."""
    import h5py

    from anatomix_tpu_torch.segmentation.data import natsorted

    os.makedirs(out_dir, exist_ok=True)
    view1s = natsorted(glob(os.path.join(views_dir, "view1", "*.nii.gz")))
    labels = {
        os.path.basename(p): p
        for p in glob(os.path.join(labels_dir, "*.nii.gz"))
    }
    assert len(view1s) > 0, "no views found"

    def write(h5path, items, offset=0):
        with h5py.File(h5path, "w") as f:
            for n, v1path in enumerate(items):
                base = os.path.basename(v1path)[len("view1_"):]
                v2path = os.path.join(
                    views_dir, "view2", "view2_" + base
                )
                seg_path = labels[base]
                v1, _ = load_volume(v1path)
                v2, _ = load_volume(v2path)
                seg, _ = load_volume(seg_path)
                grp = f.create_group(f"{n + offset:06d}")
                grp.create_dataset(
                    "img",
                    data=np.stack([v1, v2]).astype(np.float32),
                    compression="gzip",
                )
                grp.create_dataset(
                    "seg", data=seg.astype(np.uint8), compression="gzip"
                )

    if val_count > 0:
        write(os.path.join(out_dir, "train_data.hdf5"),
              view1s[:-val_count])
        write(os.path.join(out_dir, "val_data.hdf5"), view1s[-val_count:])
    else:
        write(os.path.join(out_dir, "train_data.hdf5"), view1s)


def generate_training_data(
    template_dir: str,
    work_dir: str,
    n_vols: int,
    val_count: int = 0,
    sidelen: int = 128,
    max_workers=None,
    seed: int = 0,
):
    """End-to-end step1 -> step2 -> step3 (the reference's
    `generate_training_data.sh`)."""
    segs = sorted(glob(os.path.join(template_dir, "*.nii.gz"))) + sorted(
        glob(os.path.join(template_dir, "*.npz"))
    )
    assert segs, f"no templates in {template_dir}"
    labels_dir = os.path.join(work_dir, "label_ensembles")
    views_dir = os.path.join(work_dir, "views")
    h5_dir = os.path.join(work_dir, "h5_w_segs")
    label_paths = run_step1(
        segs, n_vols, labels_dir, sidelen=sidelen,
        max_workers=max_workers, base_seed=seed,
    )
    run_step2(
        label_paths, views_dir, max_workers=max_workers,
        base_seed=seed + 10_000_000,
    )
    run_step3(views_dir, labels_dir, h5_dir, val_count=val_count)
    return os.path.join(h5_dir, "train_data.hdf5")


def main(argv=None):
    """CLI for the full synthesis pipeline (the reference runs
    step0..step3 as separate scripts chained by
    `generate_training_data.sh`; step0 is exposed via --step0_subjects)."""
    import argparse

    p = argparse.ArgumentParser(
        description="anatomix synthetic training-data generation"
    )
    p.add_argument("template_dir", help="organ label templates (*.nii.gz)")
    p.add_argument("work_dir")
    p.add_argument("--n_vols", type=int, default=100,
                   help="label ensembles to synthesize (reference: 120000)")
    p.add_argument("--val_count", type=int, default=0)
    p.add_argument("--sidelen", type=int, default=128)
    p.add_argument("--max_workers", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--step0_subjects", type=str, default=None,
                   help="TotalSegmentator root: run the step0 rib/vertebra "
                        "merge into template_dir first")
    args = p.parse_args(argv)

    if args.step0_subjects:
        subjects = sorted(
            d for d in glob(os.path.join(args.step0_subjects, "*"))
            if os.path.isdir(d)
        )
        for sub in subjects:
            merge_vertebrae_and_ribs(sub, args.template_dir)
    out = generate_training_data(
        args.template_dir, args.work_dir, args.n_vols,
        val_count=args.val_count, sidelen=args.sidelen,
        max_workers=args.max_workers, seed=args.seed,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
