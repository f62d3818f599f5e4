"""The ViT's train walk for every config `Primus.forward` takes, against the
JAX package on the CPU in f32: the v1 tokenizer (the stride-p patch-embed
conv and its token LayerNorm) at patches 2, 4, 8 and 16, every output norm
for v1 and v2, and with the v1 tokenizer `nce_forward`'s loss and
gradients, two train steps and a JAX run's resumed train state.

A small `PrimusConfig` (embed 32, one EVA block, 2 heads, 2 registers,
qk_norm, the inner norm, LayerScale 0.1); G's parameters are the port's
seeded init, carried to JAX's layout; inputs and the cotangent come from
a numpy seed. The walk is held to `jax.vjp` of `primus_apply` (jitted once
per config). Every leaf is held within 1e-4 of its scale
(`test_torch_vit_pretrain._assert_leaves_close`); v2's tokenizer conv
weights within 3e-4, as in that file. Under `demean` and `instance` the
output norm subtracts each channel's mean, so the final decoder bias's
gradient is zero in exact arithmetic and f32 noise on both sides (JAX's
reaches 1e-6 of the network's largest gradient): the port's is held within
twice JAX's own plus 1e-6 of that largest gradient. Patches 2 and 4
(one and two decoder stages) and 16 (four) run the stage path's L + L-il
exit, patch 8 the block-space walk's V1 exit; on the CPU each kernel
wrapper runs its plain version, and `plain=True` is the f32 plain path
(`F.conv3d` with stride p, torch's reshapes).

The step tests sample every voxel of the output (`num_patches` = 512 at
8^3), so that the two frameworks' different random draws do not matter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.models.vit3d import PrimusConfig as JPrimusConfig
from anatomix_tpu.models.vit3d import primus_apply as jprimus_apply
from anatomix_tpu.pretraining import train_step as jts
from anatomix_tpu.utils.checkpoint import load_state_leaves, save_state_leaves
from anatomix_tpu_torch.models.convert import from_jax_train_state
from anatomix_tpu_torch.models.vit3d import (
    PrimusConfig,
    from_jax_primus_params,
    init_primus_params,
)
from anatomix_tpu_torch.models.vit3d.convert import to_jax_primus_params
from anatomix_tpu_torch.models.vit3d.primus import _decoder_widths
from anatomix_tpu_torch.models.vit3d.primus_train import primus_train_apply
from anatomix_tpu_torch.pretraining import train_step as ts
from anatomix_tpu_torch.pretraining.jax_state import (
    jax_state_keys,
    load_jax_train_state,
)

from test_torch_vit_pretrain import _assert_leaves_close, _strong

BASE = dict(input_channels=1, num_classes=4, embed_dim=32, eva_depth=1,
            eva_numheads=2, num_register_tokens=2, qk_norm=True,
            scale_attn_inner=True, init_values=0.1, out_norm="demean")
# the smallest input each patch tiles with more than one token
SHAPES = {2: (8, 8, 8), 4: (16, 16, 8), 8: (16, 16, 8), 16: (32, 16, 16)}
OUT_NORMS = ("none", "instance", "layernorm", "demean")
# the step tests: v1 at patch 4 (two decoder stages, the stage path)
STEP = dict(BASE, version="v1", patch_embed_size=(4, 4, 4),
            input_shape=(8, 8, 8))
P_ALL = 8 * 8 * 8  # every voxel of the tap
NCE = dict(tap_layers=(-1,), num_patches=P_ALL)
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these tiny volumes: the suite runs several
    workers, and many threads on small ops only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(version, patch, out_norm="demean"):
    kw = dict(BASE, version=version, patch_embed_size=(patch,) * 3,
              input_shape=SHAPES[patch], out_norm=out_norm)
    return kw


def _tol(key: str) -> float:
    """1e-4 of the leaf's scale; 3e-4 for v2's tokenizer 3x3x3 conv
    weights (`test_torch_vit_pretrain._leaf_tol`)."""
    conv = key.startswith("tokenizer.") and key.endswith(".weight") and (
        "proj" not in key)
    return 3e-4 if conv else 1e-4


@functools.lru_cache(maxsize=None)
def _walk(items):
    """The seeded parameters, input and cotangent of config `items`, JAX's
    output and parameter gradients (jitted `jax.vjp` of `primus_apply`),
    and the port's on both routes: {plain: (output, gradients)}."""
    kw = dict(items)
    cfg, jcfg = PrimusConfig(**kw), JPrimusConfig(**kw)
    sd = init_primus_params(cfg, torch.Generator().manual_seed(0))
    shape = (2, *cfg.input_shape)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((*shape, 1)).astype(np.float32)
    g = rng.standard_normal((*shape, cfg.num_classes)).astype(np.float32)

    def f(p, x, g):
        out, vjp = jax.vjp(lambda p: jprimus_apply(jcfg, p, x), p)
        return out, vjp(g)[0]

    jp = jax.tree_util.tree_map(jnp.asarray, to_jax_primus_params(cfg, sd))
    out, grads = jax.jit(f)(jp, jnp.asarray(x), jnp.asarray(g))
    ref = (torch.from_numpy(np.array(out)), from_jax_primus_params(
        cfg, jax.tree_util.tree_map(np.asarray, grads)))
    port = {}
    for plain in (False, True):
        leaves = {k: v.clone().requires_grad_() for k, v in sd.items()}
        y = primus_train_apply(cfg, leaves, torch.from_numpy(x),
                               compute_dtype=torch.float32, plain=plain)
        gr = torch.autograd.grad(y, list(leaves.values()),
                                 torch.from_numpy(g), allow_unused=True)
        port[plain] = (y.detach(), {
            k: torch.zeros_like(v) if d is None else d
            for (k, v), d in zip(leaves.items(), gr)})
    return ref, port


def _assert_walk_matches(kw, plain):
    (out, grads), port = _walk(tuple(sorted(kw.items())))
    got, got_grads = port[plain]
    assert got.shape == out.shape
    assert float((got - out).abs().max()) <= 1e-4 * float(out.abs().max())
    assert sorted(got_grads) == sorted(grads)
    got_grads, grads = dict(got_grads), dict(grads)
    if kw["out_norm"] in ("demean", "instance"):
        # the final bias cancels: its gradient is f32 noise on both sides
        key = f"decoder.{len(_decoder_widths(PrimusConfig(**kw))) - 1}.bias"
        net = max(float(v.abs().max()) for v in grads.values())
        noise = float(grads.pop(key).abs().max())
        assert float(got_grads.pop(key).abs().max()) <= (
            2 * noise + 1e-6 * net)
    _assert_leaves_close(got_grads, grads, _tol)


@pytest.mark.parametrize("plain", [False, True], ids=["kernel_route",
                                                      "plain"])
@pytest.mark.parametrize("patch", [2, 4, 8, 16])
def test_v1_train_walk_matches_jax(patch, plain):
    """The v1 walk's output volume and every leaf's gradient against
    `jax.vjp` of `primus_apply`: the kernel route (L-c1 + L chain and the
    f32 GEMM; the stage path with L and L-il, or at patch 8 the block-space
    walk with V1) and the f32 plain path."""
    _assert_walk_matches(_cfg("v1", patch), plain)


@pytest.mark.parametrize("plain", [False, True], ids=["kernel_route",
                                                      "plain"])
@pytest.mark.parametrize("out_norm", OUT_NORMS)
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_output_norms_match_jax(version, out_norm, plain):
    """Every output norm: v1 at patch 4 (the stage path's L-il exit, plus
    the final bias outside `demean`) and v2 at patch 8 (the block-space
    V1 exit), then `build_out_norm` as autograd; output and gradients
    against `jax.vjp` of `primus_apply`."""
    _assert_walk_matches(_cfg(version, 4 if version == "v1" else 8,
                              out_norm), plain)


def test_train_walk_takes_every_forward_config():
    """The walk's envelope is `Primus.forward`'s: v1 at any cubic
    power-of-two patch, every output norm; v2 only at patch 8."""
    from anatomix_tpu_torch.models.vit3d.primus_train import (
        check_train_supported,
    )

    for patch in (2, 4, 8, 16):
        for norm in OUT_NORMS + ("in", "ln", "identity", "center"):
            check_train_supported(PrimusConfig(**_cfg("v1", patch, norm)))
    with pytest.raises(NotImplementedError):
        check_train_supported(PrimusConfig(**dict(
            _cfg("v2", 8), patch_embed_size=(4, 4, 4))))
    with pytest.raises(ValueError, match="unsupported output"):
        primus_train_apply(
            PrimusConfig(**_cfg("v1", 2, "batch")),
            init_primus_params(PrimusConfig(**_cfg("v1", 2))),
            torch.zeros(1, 8, 8, 8), compute_dtype=torch.float32)


# -----------------------------------------------------------------------------
# the v1 step: nce_forward, two train steps, a JAX run resumed

def _state_np(jstate):
    return jax.tree_util.tree_map(np.asarray, {
        "step": jstate.step, "params_g": jstate.params_g,
        "params_f": jstate.params_f, "lr_scale": jstate.lr_scale})


@pytest.fixture(scope="module")
def v1():
    """JAX's v1 train state (G from the port's seeded init), its gradients
    of `nce_forward` and two steps of `build_train_step` (the state after
    the first saved as leaves), and a seeded batch."""
    cfg, jcfg = PrimusConfig(**STEP), JPrimusConfig(**STEP)
    params_g = jax.tree_util.tree_map(jnp.asarray, to_jax_primus_params(
        cfg, init_primus_params(cfg, torch.Generator().manual_seed(4))))
    jstate = _strong(jts.init_train_state(
        jcfg, jax.random.PRNGKey(0), tap_layers=(-1,), num_patches=P_ALL,
        netf_nc=16, lr=LR, params_g=params_g))
    rng = np.random.default_rng(5)
    views = rng.standard_normal((1, 2, 8, 8, 8, 1)).astype(np.float32)
    segs = rng.integers(0, 4, (1, 8, 8, 8, 1)).astype(np.int32)

    def jloss(pg, pf):
        return jts.nce_forward(
            jcfg, pg, pf, jnp.asarray(views), jnp.asarray(segs),
            jax.random.PRNGKey(3), nce=jts.NCEOptions(temperature=0.33),
            train=True, **NCE)

    (loss, aux), (rg, rf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jstate.params_g,
                                              jstate.params_f)
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    jgrads = dict(loss=float(loss), aux=aux,
                  g=from_jax_primus_params(cfg, tree(rg)),
                  f=ts.tree_map(lambda a: torch.from_numpy(
                      np.array(a, np.float32)), tree(rf)))
    jstep = jts.build_train_step(jcfg, nce_temperature=0.33, lr=LR,
                                 donate=False, **NCE)
    batch = (jnp.asarray(views), jnp.asarray(segs), jax.random.PRNGKey(5))
    states, metrics = [jstate], []
    for _ in range(2):
        s, m = jstep(states[-1], *batch)
        states.append(s)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, jstates=states, jmetrics=metrics, jgrads=jgrads,
                views=views, segs=segs)


@pytest.mark.parametrize("plain", [False, True], ids=["kernel_route",
                                                      "plain"])
def test_v1_nce_forward_loss_and_grads_match_jax(v1, plain):
    """The v1 step's loss and every leaf's gradient of G and F against
    JAX's `value_and_grad` of `nce_forward`, within 1e-4 of each leaf's
    scale."""
    state = from_jax_train_state(_state_np(v1["jstates"][0]), v1["cfg"])
    loss, aux, grads_g, grads_f = ts.nce_loss_and_grads(
        v1["cfg"], state.params_g, state.params_f,
        torch.from_numpy(v1["views"]), torch.from_numpy(v1["segs"]),
        torch.Generator().manual_seed(3),
        nce=ts.NCEOptions(temperature=0.33), compute_dtype=torch.float32,
        plain=plain, **NCE)
    ref = v1["jgrads"]
    assert abs(float(loss) - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    assert list(aux["per_layer"]) == ["-1"]
    assert sorted(grads_g) == sorted(ref["g"])
    assert "tokenizer.proj.weight" in grads_g
    assert grads_g["tokenizer.proj.weight"].shape == (32, 1, 4, 4, 4)
    _assert_leaves_close(grads_g, ref["g"], _tol)
    _assert_leaves_close(grads_f, ref["f"], _tol)


def test_v1_two_train_steps_match_jax(v1):
    """Two AdamW steps against JAX's `build_train_step` from the same
    state: run freely, each step's loss within 1e-4 and its learning rate;
    run from JAX's state before it, the loss and G's and F's gradient norms
    within 1e-4 (AdamW's sign-like first update moves the weights whose
    gradient is at f32 rounding by up to twice the rate, so free runs
    drift, as in `test_torch_vit_pretrain.py`)."""
    cfg = v1["cfg"]
    step = ts.build_train_step(cfg, lr=LR, compute_dtype=torch.float32,
                               **NCE)
    state = from_jax_train_state(_state_np(v1["jstates"][0]), cfg)
    for i in range(2):
        ref = v1["jmetrics"][i]
        forced = from_jax_train_state(_state_np(v1["jstates"][i]), cfg)
        _, fm = step(forced, v1["views"], v1["segs"],
                     torch.Generator().manual_seed(5))
        state, m = step(state, v1["views"], v1["segs"],
                        torch.Generator().manual_seed(5))
        assert abs(float(m["loss"]) - ref["loss"]) <= 1e-4 * abs(
            ref["loss"]), i
        assert float(m["lr"]) == pytest.approx(ref["lr"], rel=1e-6)
        for key in ("loss", "grad_norm_G", "grad_norm_F"):
            assert float(fm[key]) == pytest.approx(ref[key], rel=1e-4), (
                i, key)
    assert state.step == 2 and state.opt_state_g["count"] == 2


def test_v1_jax_train_state_resumes(v1, tmp_path):
    """A JAX v1 run's state after one step, saved as ordered leaves, read
    through `load_jax_train_state`: the leaf names agree with JAX's treedef
    (`tokenizer.proj`, `tokenizer.norm`), parameters and AdamW moments land
    bit for bit, and the next step from it matches JAX's second step (loss
    and gradient norms within 1e-4)."""
    cfg = v1["cfg"]
    jstate = v1["jstates"][1]
    path = str(tmp_path / "latest_train_state.npz")
    save_state_leaves(path, jstate)
    like = from_jax_train_state(_state_np(v1["jstates"][0]), cfg)
    state = load_jax_train_state(path, cfg, like, device="cpu")
    keys = jax_state_keys(cfg, like.params_g, like.params_f)
    assert len(keys) == len(jax.tree_util.tree_leaves(
        load_state_leaves(path, jstate)))
    assert ("params_g", "tokenizer/norm/scale") in keys
    assert ("params_g", "tokenizer/proj/w") in keys
    assert state.step == 1 and state.opt_state_g["count"] == 1
    ref = to_jax_primus_params(cfg, state.params_g)
    for (k, got), (_, want) in zip(ts.tree_items(ref),
                                   ts.tree_items(jax.tree_util.tree_map(
                                       np.asarray, jstate.params_g))):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=k)
    adam = jstate.opt_state_g.inner_states["train"].inner_state[0]
    for moment in ("mu", "nu"):
        got = to_jax_primus_params(cfg, state.opt_state_g[moment])
        for (k, a), (_, b) in zip(ts.tree_items(got), ts.tree_items(
                jax.tree_util.tree_map(np.asarray, getattr(adam, moment)))):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=k)
    step = ts.build_train_step(cfg, lr=LR, compute_dtype=torch.float32,
                               **NCE)
    _, m = step(state, v1["views"], v1["segs"],
                torch.Generator().manual_seed(5))
    ref = v1["jmetrics"][1]
    for key in ("loss", "grad_norm_G", "grad_norm_F"):
        assert float(m[key]) == pytest.approx(ref[key], rel=1e-4), key
