"""The port's registration slice on the CPU against the JAX package on the
same numpy inputs (and, end to end, the same UNet weights): MIND-SSC, the
correlation and coupled convex solver, the field utilities, stage 1, the
Adam instance optimisation, the feature merge, `register_pair`, the CLI and
the macro-Dice.

Free-running Adam runs are held with the two-part rule: within 2.5x the
spread of JAX's own `run_instance_opt` under a 1-ulp perturbation of its
inputs, + 1e-3 (Adam's first step is lr * g / (|g| + eps), about +-1 for
any gradient above 1e-8, so an element whose gradient is rounding noise
steps a whole grid unit either way). Each step is also checked from JAX's
own state."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from anatomix_tpu.models import unet as jax_unet
from anatomix_tpu.ops import pool as jax_pool
from anatomix_tpu.ops import resize as jax_resize
from anatomix_tpu.utils.nifti import save_volume
from anatomix_tpu_torch.models.convert import from_jax_params, to_jax_params
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.ops import grid_sample as gs
from anatomix_tpu_torch.ops import pool
from anatomix_tpu_torch.ops import resize


# `anatomix_tpu.ops` and `.registration` rebind some module names to
# functions of the same name; the modules are imported by path
jax_gs = importlib.import_module("anatomix_tpu.ops.grid_sample")


def _jax(name):
    return importlib.import_module(f"anatomix_tpu.registration.{name}")


def _port(name):
    return importlib.import_module(f"anatomix_tpu_torch.registration.{name}")


def _vol(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, ref, atol, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _witness_rule(got, ref, perturbed):
    """max|port - JAX| <= 2.5 x max|JAX(1-ulp inputs) - JAX| + 1e-3."""
    spread = np.abs(np.asarray(perturbed) - np.asarray(ref)).max()
    err = np.abs(got - np.asarray(ref)).max()
    assert err <= 2.5 * spread + 1e-3, (err, spread)


def _ulp(a):
    return np.nextafter(np.asarray(a, np.float32), np.float32(np.inf))


# -- descriptors and stage 1 -------------------------------------------------

@pytest.mark.parametrize("shape,radius,dilation", [((12, 14, 16), 1, 2),
                                                    ((10, 9, 11), 2, 1)])
def test_mindssc_matches_jax(shape, radius, dilation):
    img = _vol((1, *shape, 1), seed=0, scale=50.0)
    got = _port("mind").mindssc(torch.from_numpy(img), radius, dilation)
    ref = _jax("mind").mindssc(jnp.asarray(img), radius, dilation)
    assert got.shape == ref.shape == (1, *shape, 12)
    _close(got, ref, atol=1e-5, rtol=1e-4)
    pts = _vol((3, 7), seed=1)
    np.testing.assert_array_equal(_port("mind").pdist_squared(pts),
                                  _jax("mind").pdist_squared(pts))


def _feature_pair(shape, C, seed):
    """Two feature volumes with a block where both are one constant (as
    air is after minmax): there every shift's SSD is the same number."""
    f = _vol((1, *shape, C), seed)
    m = _vol((1, *shape, C), seed + 1)
    f[:, :6, :6, :6] = 0.25
    m[:, :8, :8, :8] = 0.25
    return f, m


# the constant block of `test_correlate_and_coupled_convex_match_jax`
_BLOCK = slice(4, 18)


@pytest.mark.parametrize("hw", [1, 2])
def test_correlate_and_coupled_convex_match_jax(hw):
    shape = (24, 22, 26)
    f = _vol((1, *shape, 5), seed=2)
    m = _vol((1, *shape, 5), seed=12)
    # a 14^3 block where both volumes are one constant, as air is after
    # minmax: there every shift's SSD is 0 in both frameworks
    f[:, _BLOCK, _BLOCK, _BLOCK] = 0.25
    m[:, _BLOCK, _BLOCK, _BLOCK] = 0.25
    ssd, arg = _port("correlate").correlate(torch.from_numpy(f),
                                            torch.from_numpy(m), hw)
    jssd, jarg = _jax("correlate").correlate(jnp.asarray(f), jnp.asarray(m),
                                             hw)
    assert ssd.shape == jssd.shape == ((2 * hw + 1) ** 3, *shape)
    _close(ssd, jssd, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
    # inside the block by the search radius plus the two 3^3 smoothings,
    # every shift ties exactly and both take index 0
    inner = slice(_BLOCK.start + hw + 2, _BLOCK.stop - hw - 2)
    tied = arg[inner, inner, inner]
    assert tied.numel() > 0 and (tied == 0).all()
    assert (ssd[:, inner, inner, inner] == 0).all()
    mesh = _port("correlate").displacement_mesh(hw)
    np.testing.assert_array_equal(mesh, _jax("correlate").displacement_mesh(hw))
    got = _port("correlate").coupled_convex(ssd, arg, torch.from_numpy(mesh))
    ref = _jax("correlate").coupled_convex(jssd, jarg, jnp.asarray(mesh))
    assert got.shape == ref.shape == (1, *shape, 3)
    _close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ic", [True, False])
def test_run_stage1_registration_matches_jax(ic):
    """At full-resolution extents that grid_sp 2 does not divide."""
    f, m = _feature_pair((10, 9, 11), 6, seed=3)
    sizes = (21, 19, 23)
    got = _port("solver").run_stage1_registration(
        torch.from_numpy(f), torch.from_numpy(m), 1, 2, sizes, ic)
    ref = _jax("solver").run_stage1_registration(
        jnp.asarray(f), jnp.asarray(m), 1, 2, sizes, ic)
    assert got.shape == ref.shape
    _close(got, ref, atol=1e-4, rtol=1e-3)


# -- field utilities -----------------------------------------------------------

def test_inverse_consistency_matches_jax():
    d1 = _vol((1, 9, 10, 8, 3), seed=4, scale=0.05)
    d2 = _vol((1, 9, 10, 8, 3), seed=5, scale=0.05)
    got = _port("warp").inverse_consistency(torch.from_numpy(d1),
                                            torch.from_numpy(d2), 15)
    ref = _jax("warp").inverse_consistency(jnp.asarray(d1), jnp.asarray(d2),
                                           15)
    for g, r in zip(got, ref):
        _close(g, r, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_volume_matches_jax(mode):
    rng = np.random.default_rng(6)
    if mode == "nearest":  # labels: the warp moves values, exactly
        vol = rng.integers(0, 5, (1, 12, 11, 13, 1)).astype(np.float32)
    else:
        vol = _vol((1, 12, 11, 13, 2), seed=6, scale=100.0)
    disp = _vol((1, 12, 11, 13, 3), seed=7, scale=2.0)
    got = _port("warp").warp_volume(torch.from_numpy(vol),
                                    torch.from_numpy(disp), mode=mode)
    ref = _jax("warp").warp_volume(jnp.asarray(vol), jnp.asarray(disp),
                                   mode=mode)
    if mode == "nearest":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        _close(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("name", ["diffusion_regularizer", "normalize_disp",
                                  "smooth_disp", "generate_grid",
                                  "jacobian_det"])
def test_field_utilities_match_jax(name):
    disp = _vol((1, 9, 8, 10, 3), seed=8)
    t, j = torch.from_numpy(disp), jnp.asarray(disp)
    P, J = _port("warp"), _jax("warp")
    if name == "diffusion_regularizer":
        _close(P.diffusion_regularizer(t, 0.75),
               J.diffusion_regularizer(j, 0.75), atol=1e-6, rtol=1e-6)
    elif name == "normalize_disp":
        _close(P.normalize_disp(t), J.normalize_disp(j), atol=0, rtol=1e-7)
    elif name == "smooth_disp":
        for k in (3, 5):
            _close(P.smooth_disp(t, k), J.smooth_disp(j, k), atol=1e-6,
                   rtol=1e-5)
    elif name == "generate_grid":
        np.testing.assert_array_equal(P.generate_grid((9, 8, 10)).numpy(),
                                      np.asarray(J.generate_grid((9, 8, 10))))
    else:
        grid = P.generate_grid((9, 8, 10))
        got = P.jacobian_det(torch.flip(t, dims=(-1,)), grid)
        ref = J.jacobian_det(j[..., ::-1], jnp.asarray(grid.numpy()))
        assert got.shape == (1, 8, 7, 9)
        _close(got, ref, atol=1e-5, rtol=1e-5)
        # the identity has determinant 1 in this channel order
        ones = P.jacobian_det(torch.zeros_like(t), grid)
        np.testing.assert_array_equal(ones.numpy(), 1.0)


# -- instance optimisation -----------------------------------------------------

IO_SHAPE = (1, 16, 14, 18)  # the grid at spacing 2: 8 x 7 x 9 (inexact step)


def _io_inputs(zero_start: bool):
    F1 = _vol((*IO_SHAPE, 6), seed=9)
    F2 = _vol((*IO_SHAPE, 6), seed=10)
    d0 = (np.zeros((*IO_SHAPE, 3), np.float32) if zero_start
          else _vol((*IO_SHAPE, 3), seed=11, scale=1.5))
    return d0, F1, F2


@pytest.mark.parametrize("zero_start", [False, True])
def test_instance_opt_steps_from_jax_state(zero_start):
    """Three Adam steps, each started from JAX's weights and optax state:
    the port's gradient within 1e-5 of max|g| of JAX's (at a zero start the
    samples lie on voxel centres, where the sampler's gradient is
    one-sided), and its updated weights within 3e-5 (lr 1) of JAX's
    wherever |g| > 1e-3 max|g| (below that an element's gradient is near
    rounding noise, and Adam's normalised step amplifies it). optax
    computes the bias correction 1 - 0.999^t in f32, torch in f64: that
    alone moves optax's steps of about lr by up to 1.3e-5 relative."""
    d0, F1, F2 = _io_inputs(zero_start)
    g, lam = 2, 0.75
    # JAX: the pieces of `run_instance_opt`'s loss, composed as it does
    pf = jax_pool.avg_pool(jnp.asarray(F1), g)
    pm = jax_pool.avg_pool(jnp.asarray(F2), g)
    Hg, Wg, Dg = pf.shape[1:4]
    w = jax_resize.resize3d(jnp.asarray(d0), (Hg, Wg, Dg),
                            mode="trilinear") / g
    jscale = jnp.asarray([(Hg - 1) / 2.0, (Wg - 1) / 2.0, (Dg - 1) / 2.0],
                         jnp.float32)
    jgrid0 = jax_gs.identity_grid((Hg, Wg, Dg))
    sample = jax_gs.make_packed_sampler(pm)

    def loss_fn(w):
        ds = jax_pool.box_filter(w, 3, 3)
        reg = _jax("warp").diffusion_regularizer(ds, lam)
        s = sample(jgrid0 + (ds / jscale)[..., ::-1])
        return jnp.mean(jnp.mean((s - pf) ** 2, axis=-1) * 12.0) + reg

    grad_fn = jax.jit(jax.grad(loss_fn))
    tx = optax.adam(1.0)
    state = tx.init(w)
    # the port: the same inputs through its own pieces
    P = _port("solver")
    tpf = pool.avg_pool(torch.from_numpy(F1), g)
    tpm = pool.avg_pool(torch.from_numpy(F2), g)
    tscale = torch.tensor([(Hg - 1) / 2.0, (Wg - 1) / 2.0, (Dg - 1) / 2.0])
    tgrid0 = gs.identity_grid((Hg, Wg, Dg))
    np.testing.assert_array_equal(tgrid0.numpy(), np.asarray(jgrid0))
    for _ in range(3):
        jg = grad_fn(w)
        updates, new_state = tx.update(jg, state, w)
        w_next = optax.apply_updates(w, updates)

        wt = torch.tensor(np.asarray(w), requires_grad=True)
        loss, _ = P.instance_loss(wt, tpf, tpm, tgrid0, tscale, lam)
        loss.backward()
        jg = np.asarray(jg)
        gmax = np.abs(jg).max()
        assert np.abs(wt.grad.numpy() - jg).max() <= 1e-5 * gmax
        opt = torch.optim.Adam([wt], lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        adam = state[0]
        opt.state[wt] = {
            "step": torch.tensor(float(adam.count)),
            "exp_avg": torch.tensor(np.asarray(adam.mu)),
            "exp_avg_sq": torch.tensor(np.asarray(adam.nu)),
        }
        opt.step()
        big = np.abs(jg) > 1e-3 * gmax
        np.testing.assert_allclose(wt.detach().numpy()[big],
                                   np.asarray(w_next)[big], atol=3e-5,
                                   rtol=0)
        w, state = w_next, new_state


@pytest.mark.parametrize("zero_start,smooth", [(False, 0), (False, 3),
                                               (True, 0)])
def test_run_instance_opt_matches_jax_witness(zero_start, smooth):
    """Five free-running iterations from the same inputs."""
    d0, F1, F2 = _io_inputs(zero_start)
    kw = dict(selected_niter=5, selected_smooth=smooth)
    got = _port("solver").run_instance_opt(
        torch.from_numpy(d0), torch.from_numpy(F1), torch.from_numpy(F2),
        **kw).numpy()
    J = _jax("solver").run_instance_opt
    ref = J(jnp.asarray(d0), jnp.asarray(F1), jnp.asarray(F2), **kw)
    perturbed = J(jnp.asarray(_ulp(d0)), jnp.asarray(_ulp(F1)),
                  jnp.asarray(_ulp(F2)), **kw)
    assert got.shape == ref.shape == (*IO_SHAPE, 3)
    _witness_rule(got, ref, perturbed)


# -- merge, pipeline, CLI --------------------------------------------------------

@pytest.mark.parametrize("use_mask", [False, True])
def test_merge_features_matches_jax(use_mask):
    shape = (14, 12, 16)
    fixed = np.abs(_vol(shape, seed=12, scale=300.0))
    moving = np.abs(_vol(shape, seed=13, scale=300.0))
    pf = _vol((1, *shape, 4), seed=14)
    pm = _vol((1, *shape, 4), seed=15)
    masks = (None, None)
    if use_mask:
        g = np.indices(shape)
        masks = tuple(
            (((g - np.array(c)[:, None, None, None]) ** 2).sum(0) < 25
             ).astype(np.float32) for c in ((7, 6, 8), (6, 5, 9)))
    got = _port("merge").merge_features(
        use_mask, torch.from_numpy(pf), torch.from_numpy(pm), *masks, fixed,
        moving)
    ref = _jax("merge").merge_features(
        use_mask, jnp.asarray(pf), jnp.asarray(pm), *masks, fixed, moving)
    for g_, r in zip(got, ref):
        assert g_.shape == r.shape
        _close(g_, r, atol=1e-5, rtol=1e-4)
    assert got[2].shape == (1, *shape, 16)


def _sphere(size, center, radius):
    g = np.stack(np.meshgrid(*[np.arange(size)] * 3, indexing="ij"),
                 axis=-1).astype(np.float32)
    dist = np.linalg.norm(g - np.asarray(center, np.float32), axis=-1)
    return np.clip(1.0 - dist / radius, 0, 1) * 200.0, (dist < radius
                                                        ).astype(np.float32)


TINY = dict(dimension=3, input_nc=1, output_nc=4, num_downs=2, ngf=4)


@pytest.fixture(scope="module")
def tiny_models():
    """JAX's tiny UNet and the port's on the same weights: seeded by the
    port (JAX's eager init compiles for tens of seconds on the CPU),
    written as JAX's pytree, read back through `from_jax_params`."""
    plan = build_plan(UnetConfig(**TINY))
    params = to_jax_params(plan, init_params(plan,
                                             torch.Generator().manual_seed(0)))
    jplan = jax_unet.build_plan(jax_unet.UnetConfig(**TINY))
    return jplan, params, plan, from_jax_params(plan, params)


def test_register_pair_matches_jax(tiny_models):
    """The port's counterpart of tests/test_registration_e2e.py:40-64:
    32^3 spheres, 30 Adam iterations, `sliding`, in f32 on the CPU."""
    jplan, params, plan, sd = tiny_models
    fixed, fixed_seg = _sphere(32, (16, 16, 16), 8)
    moving, moving_seg = _sphere(32, (19, 14, 17), 8)
    kw = dict(selected_niter=30, extract_strategy="sliding")
    disp, secs = _port("pipeline").register_pair(
        fixed, moving, plan, sd, compute_dtype=torch.float32, device="cpu",
        **kw)
    JP = _jax("pipeline")
    ref, _ = JP.register_pair(fixed, moving, jplan, params, **kw)
    perturbed, _ = JP.register_pair(fixed, _ulp(moving), jplan, params, **kw)
    assert disp.shape == (1, 32, 32, 32, 3) and secs > 0
    _witness_rule(disp.numpy(), ref, perturbed)
    moved = _port("warp").warp_volume(
        torch.from_numpy(moving_seg)[None, ..., None], disp,
        mode="nearest")[0, ..., 0].numpy()
    jmoved = np.asarray(_jax("warp").warp_volume(
        jnp.asarray(moving_seg)[None, ..., None], ref, mode="nearest"))[0, ..., 0]
    before = JP.macro_dice(fixed_seg, moving_seg)
    after = _port("pipeline").macro_dice(fixed_seg, moved)
    assert abs(after - JP.macro_dice(fixed_seg, jmoved)) <= 0.01
    assert after > before + 0.1, (before, after)


def test_registration_cli_on_the_cpu(tmp_path, tiny_models, capsys):
    """`python -m anatomix_tpu_torch.registration.cli --device cpu` on tiny
    NIfTI files, from a JAX-format `.npz`, with masks and labels."""
    from anatomix_tpu.models.load import save_npz
    from anatomix_tpu_torch.registration.cli import main
    from anatomix_tpu_torch.utils.nifti import load_volume

    _, params, _, _ = tiny_models
    ckpt = str(tmp_path / "tiny.npz")
    save_npz(ckpt, params)
    fixed, fixed_seg = _sphere(24, (12, 12, 12), 6)
    moving, moving_seg = _sphere(24, (14, 11, 12), 6)
    paths = {}
    for name, arr in [("fixed", fixed), ("moving", moving),
                      ("fixed_seg", fixed_seg), ("moving_seg", moving_seg)]:
        paths[name] = str(tmp_path / f"{name}.nii.gz")
        save_volume(paths[name], arr, np.eye(4))
    out = tmp_path / "out"
    main(["--fixed", paths["fixed"], "--moving", paths["moving"],
          "--exp_name", "t", "--ckpt_path", ckpt, "--num_downs", "2",
          "--ngf", "4", "--output_nc", "4", "--selected_niter", "5",
          "--use_mask", "--path_mask_fixed", paths["fixed_seg"],
          "--path_mask_moving", paths["moving_seg"], "--warp_seg",
          "--path_seg_fixed", paths["fixed_seg"],
          "--path_seg_moving", paths["moving_seg"],
          "--result_path", str(out), "--device", "cpu"])
    files = sorted(os.listdir(out))
    tag = "moving_g2_hw1_l0.75_ga2_icTrue_t.nii.gz"
    assert files == sorted(f"{p}_{tag}" for p in ("disp", "labels_moved",
                                                  "moved"))
    disp, _ = load_volume(str(out / f"disp_{tag}"))
    assert disp.shape == (24, 24, 24, 3) and np.isfinite(disp).all()
    labels, _ = load_volume(str(out / f"labels_moved_{tag}"))
    assert set(np.unique(labels)) <= {0.0, 1.0}
    dice = [float(l.split(":")[1]) for l in capsys.readouterr().out.split("\n")
            if l.startswith("Dice:")]
    assert len(dice) == 1 and 0.0 <= dice[0] <= 1.0


def test_macro_dice_matches_jax():
    rng = np.random.default_rng(16)
    fixed = rng.integers(0, 5, (9, 8, 7)).astype(np.float32)
    moved = rng.integers(0, 4, (9, 8, 7)).astype(np.float32)  # no label 4
    P, J = _port("pipeline").macro_dice, _jax("pipeline").macro_dice
    assert P(fixed, moved) == J(fixed, moved)
    assert P(fixed, fixed) == J(fixed, fixed) == 1.0
    assert np.isnan(P(np.zeros_like(fixed), moved))
