"""The port's `synthgen` (its own numpy/scipy copy) against the JAX
package's, on the same seeds: every public function of `core` and
`transforms_np` gives the same arrays bit for bit; step 1 (label
ensembles), step 2 (paired views) and step 3 (H5 packing) on a tiny label
map write the same NIfTI and H5 contents; the port's pretraining dataset
reads the H5 the port wrote."""

import os

import numpy as np
import pytest

import anatomix_tpu.synthgen as J
import anatomix_tpu.synthgen.transforms_np as JT
import anatomix_tpu_torch.synthgen as P
import anatomix_tpu_torch.synthgen.transforms_np as PT
from anatomix_tpu_torch.utils.nifti import load_volume, save_volume


def _same(fn_p, fn_j, *args, seed=None, **kw):
    """Both functions on the same arguments (and, with `seed`, a fresh
    `default_rng(seed)` each): the outputs equal bit for bit."""
    def call(fn):
        extra = {} if seed is None else {"rng": np.random.default_rng(seed)}
        return np.asarray(fn(*args, **kw, **extra))

    got, ref = call(fn_p), call(fn_j)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    return got


def test_core_matches_jax():
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((6, 7, 8))
    _same(P.minmax, J.minmax, arr)
    _same(P.transform_uniform, J.transform_uniform, rng.random(5), 25, 255)
    _same(P.rescale_coords, J.rescale_coords, 9)
    _same(P.generate_grid_unit, J.generate_grid_unit, (5, 6, 7))
    _same(P.generate_voxel_sphere, J.generate_voxel_sphere, 5, (16, 16, 16))
    _same(P.generate_voxel_sphere, J.generate_voxel_sphere, 4, (16, 14, 12),
          np.array([2, -1, 1]))
    _same(P.ball, J.ball, 3)
    mask = P.generate_voxel_sphere(5, (16, 16, 16)) > 0
    _same(P.dilation, J.dilation, mask, P.ball(2))
    _same(P.erosion, J.erosion, mask, P.ball(2))
    labels = rng.integers(0, 4, (12, 12, 12)).astype(np.uint8)
    _same(P.median_filter_labels, J.median_filter_labels, labels)
    vol = np.zeros((20, 20, 20))
    vol[5:9, 6:10, 7:11] = 3
    _same(P.crop_and_pad_3d_volume, J.crop_and_pad_3d_volume, vol,
          (16, 16, 16))
    _same(P.draw_perlin, J.draw_perlin, (16, 16, 16), (4, 8), 1.0, 2.0,
          seed=1)
    _same(P.draw_perlin_deformation, J.draw_perlin_deformation,
          (3, 12, 12, 12), (4, 8), seed=2)
    _same(P.sample_corruption, J.sample_corruption, (32, 32, 32), seed=3)
    for mode in ("constant", "grid-wrap"):
        _same(P.apply_random_affine_transform,
              J.apply_random_affine_transform, labels, mode=mode, seed=4)
    label = np.zeros((12, 12, 12), np.uint8)
    label[4:] = 1
    label[:, 6:] += 1
    for zero in (0.0, 1.0):
        _same(P.sample_gmm, J.sample_gmm, np.array([30.0, 120.0, 200.0]),
              np.array([5.0, 10.0, 15.0]), label, zero_bckgnd=zero, seed=5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_transforms_np_match_jax(seed):
    """Each corruption, and the whole chain over seeds whose draws take
    different branches."""
    x = np.random.default_rng(10 + seed).random((16, 16, 16))
    for name in ("rand_bias_field", "rand_kspace_spike", "rand_gamma",
                 "rand_smooth", "rand_gibbs", "rand_sharpen",
                 "rand_low_res"):
        _same(lambda v, rng: getattr(PT, name)(v, rng),
              lambda v, rng: getattr(JT, name)(v, rng), x, seed=seed)
    _same(PT.gibbs, JT.gibbs, x, 0.2)
    _same(P.view_corruption_chain, J.view_corruption_chain, x * 100,
          seed=seed)


def _templates(root, n=3, size=24):
    os.makedirs(root)
    rng = np.random.default_rng(0)
    for i in range(n):
        vol = J.generate_voxel_sphere(int(rng.integers(4, 9)), (size,) * 3,
                                      rng.integers(-4, 4, 3))
        save_volume(os.path.join(root, f"organ{i}.nii.gz"),
                    vol.astype(np.uint8), np.eye(4))
    return sorted(os.path.join(root, f) for f in os.listdir(root))


def _read(path):
    return load_volume(path)[0]


def test_pipeline_writes_what_jax_writes(tmp_path):
    """Steps 1-3 at 32^3 in one process (max_workers 0): the same label
    ensembles (names and voxels), the same two views of each and the same
    H5 groups; the port's `H5TwoViewDataset` reads the port's file."""
    h5py = pytest.importorskip("h5py")
    segs = _templates(str(tmp_path / "templates"))
    out = {}
    for tag, mod in (("port", P), ("jax", J)):
        work = tmp_path / tag
        labels = mod.run_step1(segs, 2, str(work / "labels"), min_shapes=2,
                               max_shapes=4, sidelen=32, max_workers=0,
                               base_seed=7)
        mod.run_step2(labels, str(work / "views"), max_workers=0,
                      base_seed=11)
        mod.run_step3(str(work / "views"), str(work / "labels"),
                      str(work / "h5"), val_count=1)
        out[tag] = (work, [os.path.basename(p) for p in labels])
    (pw, pnames), (jw, jnames) = out["port"], out["jax"]
    assert pnames == jnames
    for name in pnames:
        np.testing.assert_array_equal(_read(str(pw / "labels" / name)),
                                      _read(str(jw / "labels" / name)))
        for v in ("view1", "view2"):
            np.testing.assert_array_equal(
                _read(str(pw / "views" / v / f"{v}_{name}")),
                _read(str(jw / "views" / v / f"{v}_{name}")))
    for h5 in ("train_data.hdf5", "val_data.hdf5"):
        with h5py.File(pw / "h5" / h5) as got, \
                h5py.File(jw / "h5" / h5) as ref:
            assert sorted(got) == sorted(ref) and len(got) == 1
            for grp in ref:
                for ds in ("img", "seg"):
                    np.testing.assert_array_equal(got[grp][ds][()],
                                                  ref[grp][ds][()])

    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.dataset import H5TwoViewDataset

    ds = H5TwoViewDataset(str(pw / "h5" / "train_data.hdf5"),
                          PretrainConfig(crop_size=32, batch_size=1))
    try:
        a, b, seg = ds.get(0, np.random.default_rng(0))
        assert a.shape == b.shape == seg.shape == (32, 32, 32)
        assert not np.allclose(a, b)
    finally:
        ds.close()


def test_generate_label_ensemble_and_process_volume_match_jax(tmp_path):
    """One ensemble at 32^3 (its envelope branch drawn by the seed) and the
    two views of it, each framework into its own directory."""
    segs = _templates(str(tmp_path / "templates"))
    for seed in (1, 3):
        paths = {}
        for tag, mod in (("port", P), ("jax", J)):
            d = tmp_path / f"{tag}{seed}"
            os.makedirs(d)
            paths[tag] = mod.generate_label_ensemble(
                segs, 0, 2, 4, str(d), sidelen=32, seed=seed)
            mod.process_volume(paths[tag], str(d / "views"), seed)
        assert os.path.basename(paths["port"]) == os.path.basename(
            paths["jax"])
        np.testing.assert_array_equal(_read(paths["port"]),
                                      _read(paths["jax"]))
        name = os.path.basename(paths["port"])
        for v in ("view1", "view2"):
            np.testing.assert_array_equal(
                _read(str(tmp_path / f"port{seed}" / "views" / v
                          / f"{v}_{name}")),
                _read(str(tmp_path / f"jax{seed}" / "views" / v
                          / f"{v}_{name}")))
