"""The port's ViT pretraining step (`netG="primus"`) against the JAX package
on the CPU, in f32 on both sides: `nce_forward`'s loss and every gradient
leaf of G and F, each side's gradients against a float64 witness, three
train steps, and `build_all`'s primus branch.

The small ViT of the JAX package's own primus step test (embed 32, one EVA
block, 2 heads, 2 registers, qk_norm, demean, v2 tokenizer) with the
`scale_attn_inner` and `init_values` `build_all` sets, at input 16x16x8:
the ViT has a single tap, its output volume, and the two frameworks draw
different random patches, so the sampling covers every voxel of it
(`num_patches` = 2048); then a permutation of the patches leaves the loss,
the projector's batch norms and every gradient unchanged. (At 16^3 the
loss's 2P x 2P similarity matrices would take gigabytes of CPU memory.)

`PYTHONPATH=. python tests/test_torch_vit_pretrain.py` prints the readings
behind the tolerances: each f32 evaluation's worst leaf against the
float64 witness and against JAX.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models.vit3d import PrimusConfig as JPrimusConfig
from anatomix_tpu.pretraining import train_step as jts
from anatomix_tpu_torch.models.convert import from_jax_train_state
from anatomix_tpu_torch.models.vit3d import (
    PrimusConfig,
    from_jax_primus_params,
)
from anatomix_tpu_torch.pretraining import train_step as ts

SMALL = dict(input_channels=1, num_classes=4, embed_dim=32, eva_depth=1,
             eva_numheads=2, patch_embed_size=(8, 8, 8),
             input_shape=(16, 16, 8), num_register_tokens=2, qk_norm=True,
             out_norm="demean", scale_attn_inner=True, init_values=0.1,
             version="v2")
P_ALL = 16 * 16 * 8  # every voxel of the tap
NCE = dict(tap_layers=(-1,), num_patches=P_ALL)


def _leaf_tol(key: str) -> float:
    """1e-4 of the leaf's scale; 3e-4 for the tokenizer's 3x3x3 conv
    weights, whose f32 gradients JAX's own f32 evaluation reaches only to
    about 2e-4 of their scale at this size, behind instance norms over 4 to
    512 voxels per channel (`test_f32_gradients_match_a_float64_witness`:
    the port's stay within 1e-4 of the float64 values there)."""
    conv = key.startswith("tokenizer.") and key.endswith(".weight") and (
        "proj" not in key)
    return 3e-4 if conv else 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _state_np(jstate):
    return jax.tree_util.tree_map(np.asarray, {
        "step": jstate.step, "params_g": jstate.params_g,
        "params_f": jstate.params_f, "lr_scale": jstate.lr_scale})


def _port_grads(cfg, params_g, params_f, views, segs, **kw):
    return ts.nce_loss_and_grads(
        cfg, params_g, params_f, views, torch.from_numpy(segs),
        torch.Generator().manual_seed(3),
        nce=ts.NCEOptions(temperature=0.33), **kw, **NCE)


def _assert_leaves_close(got, ref, tol):
    """Every leaf of the trees `got` and `ref` (G's state dict or F's tree)
    within `tol(key)` of the reference leaf's scale; a leaf whose reference
    is zero up to rounding (|ref| <= 1e-6 of its network's largest
    gradient, such as the tokenizer's conv biases, which the instance norms
    cancel) within that rounding."""
    errs = _leaf_errors(got, ref)
    for k, (err, scale, net) in errs.items():
        assert err <= max(tol(k) * scale, 1e-6 * net), k


def _leaf_errors(got, ref):
    """{key: (max |got - ref|, max |ref|, the largest max |ref| of the
    tree)} over the leaves of `ref`, which `got` matches key for key."""
    items = list(ts.tree_items(ref))
    assert [k for k, _ in ts.tree_items(got)] == [k for k, _ in items]
    net = max(float(r.abs().max()) for _, r in items)
    return {k: (float((g.double() - r.double()).abs().max()),
                float(r.abs().max()), net)
            for (k, g), (_, r) in zip(ts.tree_items(got), items)}


def _strong(tree):
    """`tree`'s arrays without JAX's weak types (LayerScale's `jnp.full`
    makes one, a step's output has none): a jitted step fed its own output
    then traces and compiles once, not at every step."""
    return jax.tree_util.tree_map(lambda a: jnp.array(np.asarray(a)), tree)


def _vit():
    """JAX's train state of the small ViT (its own init), the port's state
    carried from it, and a seeded batch."""
    jcfg = JPrimusConfig(**SMALL)
    cfg = PrimusConfig(**SMALL)
    jstate = _strong(jts.init_train_state(
        jcfg, jax.random.PRNGKey(0), tap_layers=(-1,), num_patches=P_ALL,
        netf_nc=16, lr=1e-3))
    rng = np.random.default_rng(5)
    views = rng.standard_normal((1, 2, 16, 16, 8, 1)).astype(np.float32)
    segs = rng.integers(0, 4, (1, 16, 16, 8, 1)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jstate=jstate, state_np=_state_np(jstate),
                views=views, segs=segs)


def _jax_grads(vit):
    """JAX's f32 `value_and_grad` of `nce_forward`: the loss, its aux, and
    G's and F's gradients in the port's layout."""
    jcfg = vit["jcfg"]

    def jloss(pg, pf):
        return jts.nce_forward(
            jcfg, pg, pf, jnp.asarray(vit["views"]), jnp.asarray(vit["segs"]),
            jax.random.PRNGKey(3), nce=jts.NCEOptions(temperature=0.33),
            train=True, **NCE)

    (loss, aux), (rg, rf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(vit["jstate"].params_g,
                                              vit["jstate"].params_f)
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(loss=float(loss), aux=aux,
                g=from_jax_primus_params(vit["cfg"], tree(rg)),
                f=ts.tree_map(_t, tree(rf)))


def _port_grads_both(vit):
    """The port's f32 loss, aux and gradients: the kernel route (autograd
    Functions on the plain versions, as on the CPU) and the plain path."""
    state = from_jax_train_state(vit["state_np"], vit["cfg"])
    return {plain: _port_grads(vit["cfg"], state.params_g, state.params_f,
                               torch.from_numpy(vit["views"]), vit["segs"],
                               compute_dtype=torch.float32, plain=plain)
            for plain in (False, True)}


def _f64_grads(vit):
    """A witness free of f32 rounding: the port's plain path evaluated in
    float64 (inside this fixture `Tensor.float()` and `torch.float32` mean
    float64, and factories make float64; the RoPE tables keep the f32
    values both frameworks use). Returns (loss, G's, F's gradients)."""
    default = torch.get_default_dtype()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        mp.setattr(torch, "float32", torch.float64)
        torch.set_default_dtype(torch.float64)
        try:
            state = from_jax_train_state(vit["state_np"], vit["cfg"])
            loss, _, grads_g, grads_f = _port_grads(
                vit["cfg"], {k: v.double() for k, v in state.params_g.items()},
                ts.tree_map(lambda v: v.double(), state.params_f),
                torch.from_numpy(vit["views"]).double(), vit["segs"],
                compute_dtype=torch.float64, plain=True)
        finally:
            torch.set_default_dtype(default)
    assert loss.dtype == grads_g["tokenizer.stem.weight"].dtype == \
        torch.float64
    return float(loss), grads_g, grads_f


vit = pytest.fixture(scope="module", name="vit")(_vit)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's side: the suite runs several
    workers, and many threads on small ops only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_grads(vit):
    return _jax_grads(vit)


@pytest.fixture(scope="module")
def port_grads(vit):
    return _port_grads_both(vit)


@pytest.fixture(scope="module")
def f64_grads(vit):
    return _f64_grads(vit)


def test_init_train_state_layout(vit):
    """G first (the ViT's state dict, every leaf trainable), then F at the
    ViT's `num_classes` width, as the JAX package lays them out."""
    cfg = vit["cfg"]
    state = ts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                tap_layers=(-1,), netf_nc=16, device="cpu")
    ported = from_jax_train_state(vit["state_np"], cfg)
    assert sorted(state.params_g) == sorted(ported.params_g)
    for k, v in state.params_g.items():
        assert v.shape == ported.params_g[k].shape, k
    assert ts.backbone_tap_channels(cfg, (-1,)) == (4,)
    assert state.params_f["mlp_0"]["linears"][0].shape[0] == 4
    mask = ts._trainable_mask(state.params_g)
    assert all(mask.values()) and len(mask) == len(state.params_g)
    jmask = jts._trainable_mask(vit["jstate"].params_g)
    assert all(jax.tree_util.tree_leaves(jmask))


@pytest.mark.parametrize("plain", [False, True])
def test_nce_forward_loss_and_grads_match_jax(vit, jax_grads, port_grads,
                                              plain):
    """The loss and every leaf's gradient of G and F against JAX's
    `value_and_grad` of `nce_forward`, within 1e-4 of the leaf's scale
    (`_leaf_tol`): the kernel route and the f32 plain path."""
    loss, aux, grads_g, grads_f = port_grads[plain]
    ref = jax_grads["loss"]
    assert abs(float(loss) - ref) <= 1e-4 * abs(ref)
    assert list(aux["per_layer"]) == list(jax_grads["aux"]["per_layer"]) \
        == ["-1"]
    assert aux["new_g_stats"] == {}
    assert sorted(grads_g) == sorted(jax_grads["g"])
    _assert_leaves_close(grads_g, jax_grads["g"], _leaf_tol)
    _assert_leaves_close(grads_f, jax_grads["f"], _leaf_tol)


@pytest.mark.parametrize("side", ["port_kernel_route", "port_plain", "jax"])
def test_f32_gradients_match_a_float64_witness(jax_grads, port_grads,
                                               f64_grads, side):
    """Each f32 evaluation against the float64 witness: the port's kernel
    route and plain path within 1e-4 of each leaf's scale; JAX's within
    3e-4, because at this size its f32 rounding moves the tokenizer's conv
    weight gradients by about 2e-4 of their scale, where the port's stay
    under 1e-4. So the port-vs-JAX gap on those leaves is JAX's f32
    rounding, not a departure of the port."""
    loss64, g64, f64 = f64_grads
    if side == "jax":
        loss, g, f = jax_grads["loss"], jax_grads["g"], jax_grads["f"]
        tol = 3e-4
    else:
        loss, _, g, f = port_grads[side == "port_plain"]
        tol = 1e-4
    assert abs(float(loss) - loss64) <= 1e-6 * abs(loss64)
    _assert_leaves_close(g, g64, lambda k: tol)
    _assert_leaves_close(f, f64, lambda k: tol)


def test_three_train_steps_match_jax(vit):
    """Three AdamW steps against JAX's `build_train_step`. Run freely from
    the same state, each step's loss agrees within 1e-4, and its learning
    rate. AdamW's first update moves every weight by about the learning
    rate in the direction of its gradient's sign, so entries whose gradient
    is at f32 rounding move apart by up to twice the rate and the two
    runs' gradients drift apart after it; so the port also runs each step
    from JAX's own state before it, where its loss and G's and F's gradient
    norms agree within 1e-4."""
    jstep = jts.build_train_step(
        vit["jcfg"], nce_temperature=0.33, lr=1e-3, donate=False, **NCE)
    step = ts.build_train_step(vit["cfg"], lr=1e-3,
                               compute_dtype=torch.float32, **NCE)
    jstate = vit["jstate"]
    state = from_jax_train_state(vit["state_np"], vit["cfg"])
    for i in range(3):
        forced = from_jax_train_state(_state_np(jstate), vit["cfg"])
        _, fm = step(forced, vit["views"], vit["segs"],
                     torch.Generator().manual_seed(5))
        jstate, rm = jstep(jstate, jnp.asarray(vit["views"]),
                           jnp.asarray(vit["segs"]), jax.random.PRNGKey(5))
        state, m = step(state, vit["views"], vit["segs"],
                        torch.Generator().manual_seed(5))
        ref = float(rm["loss"])
        assert abs(float(m["loss"]) - ref) <= 1e-4 * abs(ref), i
        assert float(m["nce_-1"]) == pytest.approx(float(rm["nce_-1"]),
                                                   rel=1e-4)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        for key in ("loss", "grad_norm_G", "grad_norm_F"):
            assert float(fm[key]) == pytest.approx(float(rm[key]),
                                                   rel=1e-4), (i, key)
    assert state.step == int(jstate.step) == 3
    assert sorted(state.opt_state_g["mu"]) == sorted(state.params_g)
    assert state.opt_state_g["count"] == 3


def test_build_all_primus_on_the_cpu():
    """`build_all(PretrainConfig(netG="primus"))` builds the 26M ViT at the
    crop size with the JAX package's settings and steps on the CPU when
    asked to (crop cut to 16^3 here)."""
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all

    cfg = PretrainConfig(netG="primus", crop_size=16, num_patches=64,
                         netF_nc=16)
    plan, taps, state, step = build_all(cfg, 1, device="cpu")
    assert taps == (-1,)
    assert (plan.embed_dim, plan.eva_depth, plan.eva_numheads,
            plan.num_register_tokens, plan.head_dim) == (396, 12, 6, 8, 66)
    assert (plan.input_shape, plan.num_classes, plan.out_norm) == (
        (16, 16, 16), cfg.output_nc, "demean")
    assert plan.qk_norm and plan.scale_attn_inner
    assert plan.init_values == 0.1 and plan.in_eps == cfg.norm_eps_G
    assert sum(v.numel() for v in state.params_g.values()) > 25e6
    rng = np.random.default_rng(0)
    views = rng.standard_normal((1, 2, 16, 16, 16, 1)).astype(np.float32)
    segs = rng.integers(0, 3, (1, 16, 16, 16, 1))
    state, metrics = step(state, views, segs,
                          torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert state.params_g["blocks.0.q_proj.weight"].device.type == "cpu"


if __name__ == "__main__":
    # The readings behind `_leaf_tol`: for each f32 evaluation, the leaf of
    # G and of F farthest from the reference, as max|err| / max|ref| (leaves
    # whose reference is zero up to rounding left out).
    state = _vit()
    f64 = _f64_grads(state)
    jax_f32 = _jax_grads(state)
    sides = {"jax": (jax_f32["g"], jax_f32["f"])}
    for plain, (_, _, g, f) in _port_grads_both(state).items():
        sides["port_plain" if plain else "port_kernel_route"] = (g, f)
    refs = {"float64 witness": (f64[1], f64[2]),
            "jax f32": (jax_f32["g"], jax_f32["f"])}
    for ref_name, (ref_g, ref_f) in refs.items():
        for name, (g, f) in sides.items():
            if name == "jax" and ref_name == "jax f32":
                continue
            for net, got, ref in (("G", g, ref_g), ("F", f, ref_f)):
                k, rel = max(((k, e / s) for k, (e, s, n) in
                              _leaf_errors(got, ref).items() if s > 1e-6 * n),
                             key=lambda t: t[1])
                print(f"{name} vs {ref_name}, {net}: worst {k} {rel:.3e}")
