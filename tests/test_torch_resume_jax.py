"""Resuming a JAX run's train state on the port (`pretraining/jax_state.py`),
on the CPU in f32: JAX's `init_train_state` and `build_train_step` take a
step (three under `grad_accum` 2: one update, one mini-step pending),
`save_state_leaves` writes the state as ordered leaves, and the port's
`load_train_state` reads it back through the trainer's fresh state. Every
leaf must land where JAX's own `load_state_leaves` puts it (parameters,
AdamW moments, counts, the MultiSteps accumulator and mini-step,
`lr_scale`), and the next step from the resumed state must match JAX's next
step: loss and gradient norms within 1e-4, and each parameter's update
within 1e-4 of its leaf's update (3e-4 for the ViT).

Cases: the 6M family (without options; with `grad_accum` 2, `grad_clip`,
`unfreeze_layers` and `actG="prelu"`), a tiny dev-topology UNet (instance
norm, Avg pool, trilinear) and the ViT at `test_torch_vit_pretrain.py`'s
smallest config. G's parameters come from the port's seeded init carried to
JAX (the ViT's from JAX's own init), as in the other step tests, with
`num_patches` covering every voxel of every tap so that the two frameworks'
random draws do not matter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models.unet import UnetConfig as JUnetConfig
from anatomix_tpu.models.unet import build_plan as jbuild_plan
from anatomix_tpu.models.vit3d import PrimusConfig as JPrimusConfig
from anatomix_tpu.pretraining import train_step as jts
from anatomix_tpu.utils.checkpoint import load_state_leaves, save_state_leaves
from anatomix_tpu_torch.models.convert import (
    from_jax_train_state,
    to_jax_params,
)
from anatomix_tpu_torch.models.unet import UnetConfig, build_plan, init_params
from anatomix_tpu_torch.models.vit3d import PrimusConfig
from anatomix_tpu_torch.models.vit3d.convert import to_jax_primus_params
from anatomix_tpu_torch.pretraining import train_step as ts
from anatomix_tpu_torch.pretraining.jax_state import jax_state_keys
from anatomix_tpu_torch.utils.checkpoint import load_train_state

TINY = dict(input_nc=1, output_nc=4, num_downs=2, ngf=4)
DEV = dict(input_nc=1, output_nc=4, num_downs=3, ngf=4, norm="instance",
           pooling="Avg", interp="trilinear", norm_eps=1e-2)
VIT = dict(input_channels=1, num_classes=4, embed_dim=32, eva_depth=1,
           eva_numheads=2, patch_embed_size=(8, 8, 8),
           input_shape=(16, 16, 8), num_register_tokens=2, qk_norm=True,
           out_norm="demean", scale_attn_inner=True, init_values=0.1,
           version="v2")
LR = 1e-3
CASES = {
    "6m": dict(unet=TINY, taps=(17, 20, 24, 31, 37), size=(8, 8, 8)),
    "6m_accum_clip_unfreeze_prelu": dict(
        unet=dict(TINY, activation="prelu"), taps=(17, 20, 24, 31, 37),
        size=(8, 8, 8), accum=2, clip=0.5, unfreeze=(3, 17)),
    "dev": dict(unet=DEV, taps=(13, 24, 31, 37), size=(16, 16, 16)),
    "vit": dict(vit=VIT, taps=(-1,), size=(16, 16, 8)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny volumes: the suite runs several
    workers, and many threads on small ops only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keystr(path) -> str:
    """A JAX key path as the port's `tree_items` path."""
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(f"[{k.idx}]")
        else:
            out.append(str(k.name))
    return "/".join(out)


def _leaves(tree) -> dict[str, np.ndarray]:
    return {_keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _adam(opt_state, accum, clip):
    """(adam state, MultiSteps state or None) of a JAX `make_optimizer`
    state."""
    multi = opt_state if accum > 1 else None
    inner = opt_state.inner_opt_state if accum > 1 else opt_state
    chain = inner.inner_states["train"].inner_state
    return (chain[1] if clip else chain)[0], multi


_RUNS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _run_dir(tmp_path_factory):
    """Where the JAX states are saved."""
    _RUNS["dir"] = tmp_path_factory.mktemp("jax_states")


def _run(name):
    """JAX's state after its first update (and a pending mini-step under
    `grad_accum` 2), saved as leaves; the port's resumed state; and both
    frameworks' next step from there."""
    if name in _RUNS:
        return _RUNS[name]
    c = CASES[name]
    accum, clip = c.get("accum", 1), c.get("clip")
    taps = c["taps"]
    num_patches = int(np.prod(c["size"]))
    if "vit" in c:
        jplan, plan = JPrimusConfig(**c["vit"]), PrimusConfig(**c["vit"])
        jparams_g, frozen = None, ()
    else:
        jplan = jbuild_plan(JUnetConfig(dimension=3, **c["unet"]))
        plan = build_plan(UnetConfig(**c["unet"]))
        params = init_params(plan, torch.Generator().manual_seed(0))
        jparams_g = jax.tree_util.tree_map(jnp.asarray,
                                           to_jax_params(plan, params))
        frozen = jts.frozen_layer_ids(jplan, c.get("unfreeze"), taps)
    common = dict(grad_accum=accum, grad_clip=clip, frozen_layers=frozen)
    jstate = jts.init_train_state(
        jplan, jax.random.PRNGKey(0), tap_layers=taps,
        num_patches=num_patches, netf_nc=16, lr=LR, params_g=jparams_g,
        **common)
    state_np = jax.tree_util.tree_map(np.asarray, {
        "step": jstate.step, "params_g": jstate.params_g,
        "params_f": jstate.params_f, "lr_scale": jstate.lr_scale})
    like = from_jax_train_state(state_np, plan, grad_accum=accum)
    jstep = jts.build_train_step(
        jplan, num_patches=num_patches, tap_layers=taps,
        nce_temperature=0.33, lr=LR, donate=False, conv_impl="xla",
        compute_dtype=jnp.float32, **common)
    rng = np.random.default_rng(5)
    views = rng.standard_normal((1, 2, *c["size"], 1)).astype(np.float32)
    segs = rng.integers(0, 4, (1, *c["size"], 1)).astype(np.int32)
    batch = (jnp.asarray(views), jnp.asarray(segs), jax.random.PRNGKey(5))
    for _ in range(2 * accum - 1):
        jstate, _ = jstep(jstate, *batch)
    path = str(_RUNS["dir"] / f"{name}.npz")
    save_state_leaves(path, jstate)
    layout = dict(plan=plan, like=like, frozen_layers=frozen,
                  grad_accum=accum)
    state = load_train_state(path, device="cpu", jax_layout=layout)
    jnext, jm = jstep(jstate, *batch)
    step = ts.build_train_step(
        plan, tap_layers=taps, num_patches=num_patches, nce_temperature=0.33,
        lr=LR, compute_dtype=torch.float32, grad_accum=accum,
        grad_clip=clip, frozen_layers=frozen)
    nxt, m = step(state, views, segs, torch.Generator().manual_seed(5))
    _RUNS[name] = dict(plan=plan, jstate=jstate, jnext=jnext, jm=jm,
                       state=state, next=nxt, m=m, path=path, like=like,
                       layout=layout, accum=accum, clip=clip)
    return _RUNS[name]


def _jax_g(plan, tree) -> dict[str, np.ndarray]:
    """The port's G tree in the JAX layout, by path."""
    to_jax = (to_jax_params if not isinstance(plan, PrimusConfig)
              else to_jax_primus_params)
    return {k: np.asarray(v) for k, v in ts.tree_items(to_jax(plan, tree))}


def _port_f(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in ts.tree_items(tree)}


@pytest.mark.parametrize("name", list(CASES))
def test_leaves_land_where_jax_puts_them(name):
    """The port's names for the file's leaves agree with JAX's treedef
    (`load_state_leaves` of the same file), and every leaf of the resumed
    state is JAX's: parameters and moments bit for bit in the port's
    layout (zero moments where the optimizer masks a leaf), the counts,
    the MultiSteps mini-step and accumulator, step and `lr_scale`."""
    r = _run(name)
    plan, jstate, state = r["plan"], r["jstate"], r["state"]
    back = load_state_leaves(r["path"], jstate)
    keys = jax_state_keys(plan, r["like"].params_g, r["like"].params_f,
                          frozen_layers=r["layout"]["frozen_layers"],
                          grad_accum=r["accum"])
    assert len(keys) == len(jax.tree_util.tree_leaves(back))
    assert state.step == int(jstate.step)
    assert state.lr_scale == float(jstate.lr_scale)
    jg, jf = _leaves(jstate.params_g), _leaves(jstate.params_f)
    assert _jax_g(plan, state.params_g).keys() == jg.keys()
    for k, v in _jax_g(plan, state.params_g).items():
        np.testing.assert_array_equal(v, jg[k], err_msg=k)
    for k, v in _port_f(state.params_f).items():
        np.testing.assert_array_equal(v, jf[k], err_msg=k)
    for name_, opt, jopt, conv in (
            ("g", state.opt_state_g, jstate.opt_state_g,
             lambda t: _jax_g(plan, t)),
            ("f", state.opt_state_f, jstate.opt_state_f, _port_f)):
        adam, multi = _adam(jopt, r["accum"], r["clip"])
        assert opt["count"] == int(adam.count) > 0, name_
        for moment in ("mu", "nu"):
            ref = _leaves(getattr(adam, moment))
            got = conv(opt[moment])
            for k, v in got.items():
                np.testing.assert_array_equal(
                    v, ref.get(k, np.zeros_like(v)), err_msg=(name_, k))
            assert set(ref) <= set(got)
        if multi is not None:
            assert opt["mini_step"] == int(multi.mini_step) == 1
            ref = _leaves(multi.acc_grads)
            got = conv(opt["acc"])
            assert got.keys() == ref.keys()
            assert any(np.abs(v).max() > 0 for v in ref.values())
            for k, v in got.items():
                np.testing.assert_array_equal(v, ref[k], err_msg=(name_, k))


@pytest.mark.parametrize("name", list(CASES))
def test_next_step_matches_jax(name):
    """From the resumed state the port's next step is JAX's: the loss and
    both gradient norms within 1e-4; each optimized leaf's update within
    1e-4 of its size (mean |update error| / mean |update|; 3e-4 for the
    ViT, whose tiny instance norms put its f32 gradients 1-3e-4 from a
    float64 witness, `test_torch_vit_pretrain.py`); the batch norms'
    running statistics within 1e-4 of their scale. With the moments carried
    over AdamW's update is no longer sign-like, so fresh moments would
    miss this by far. A leaf whose gradient is rounding noise (its second
    moment at most 1e-10 of the network's largest: the conv biases that
    the instance norms cancel) moves by at most a few learning rates on
    either side, in no comparable direction."""
    r = _run(name)
    m, jm = r["m"], r["jm"]
    for key in ("loss", "grad_norm_G", "grad_norm_F"):
        assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-4), key
    plan = r["plan"]
    tol = 3e-4 if isinstance(plan, PrimusConfig) else 1e-4
    compared = 0
    for which, conv in (("g", lambda t: _jax_g(plan, t)), ("f", _port_f)):
        adam, _ = _adam(getattr(r["jnext"], f"opt_state_{which}"),
                        r["accum"], r["clip"])
        nu = _leaves(adam.nu)
        net = max(v.max() for v in nu.values())
        got = conv(getattr(r["next"], f"params_{which}"))
        got0 = conv(getattr(r["state"], f"params_{which}"))
        ref = _leaves(getattr(r["jnext"], f"params_{which}"))
        ref0 = _leaves(getattr(r["jstate"], f"params_{which}"))
        for k, v in ref.items():
            upd, err = v - ref0[k], (got[k] - got0[k]) - (v - ref0[k])
            if k not in nu:  # running statistics, or a frozen leaf
                assert np.abs(got[k] - v).max() <= (
                    1e-4 * np.abs(v).max() + 1e-6), k
            elif nu[k].max() <= 1e-10 * net:
                assert np.abs(got[k] - got0[k]).max() <= 4 * LR, k
            else:
                assert np.abs(err).mean() <= tol * np.abs(upd).mean(), k
                compared += 1
    assert compared > 0
    assert r["next"].step == int(r["jnext"].step)


def test_wrong_leaf_count_raises_jax_message(tmp_path):
    """A file whose leaves do not fit the state (another optimizer
    setting) raises with the JAX package's message."""
    r = _run("6m")
    layout = dict(r["layout"], grad_accum=2)
    layout["like"] = from_jax_train_state(
        {"step": 0, "params_g": to_jax_params(r["plan"],
                                              r["like"].params_g),
         "params_f": jax.tree_util.tree_map(
             np.asarray, r["jstate"].params_f), "lr_scale": 1.0},
        r["plan"], grad_accum=2)
    with pytest.raises(ValueError, match=r"Checkpoint has \d+ leaves; "
                       r"template expects \d+ \(architecture/optimizer "
                       r"mismatch\)"):
        load_train_state(r["path"], device="cpu", jax_layout=layout)
    with pytest.raises(ValueError, match="jax_layout"):
        load_train_state(r["path"], device="cpu")
