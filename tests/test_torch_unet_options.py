"""Every UNet option of the JAX package on the port, on the CPU in f32:
PReLU (the learned weight shared by every act slot) and SELU, residual
connections under batch, instance and no norm, replicate and circular
padding, and 1-D and 2-D nets (run as 3-D volumes with leading singleton
axes). Each against the JAX package's `unet_apply(conv_impl="xla")` on the
same weights (`convert.from_jax_params`) and inputs (numpy, seeded):

- the eager `Unet` and the fused forward (the kernels' plain versions on
  the CPU), output and taps, at 1e-5;
- the train walks (the block walk for the 6M family's PReLU and SELU, the
  general walk for the rest; the kernels' plain versions, the dgrad's pad
  adjoint among them) and every gradient, the PReLU weight's included,
  against `jax.vjp` of `unet_apply(train=True)` evaluated in float64: the
  port's f32 walk at 1e-4, the same walk in float64 at 1e-9; two training
  steps keep the PReLU slots one weight;
- `convert` both ways for PReLU and 2-D nets, against the JAX package's
  `convert_state_dict`;
- ROADMAP F10: on a residual batch-norm UNet the port's extractor gives
  the network's features (JAX's unfolded `unet_apply`), where the JAX
  package's folded plan does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu.extract import fold_batchnorm as jax_fold_batchnorm
from anatomix_tpu.models import convert as jax_convert
from anatomix_tpu.models import unet as ju
from anatomix_tpu_torch.extract import fold_batchnorm, make_feature_extractor
from anatomix_tpu_torch.models import convert as convert_module
from anatomix_tpu_torch.models import unet as pu
from anatomix_tpu_torch.models.convert import (
    check_state_dict,
    from_jax_params,
    to_jax_params,
)
from anatomix_tpu_torch.models.unet_fused import (
    prepack_fused,
    unet_apply_fused,
)
from anatomix_tpu_torch.models.unet_train import unet_train_forward
from anatomix_tpu_torch.models.unet_train_block import train_block_eligible

TINY = dict(num_downs=2, ngf=4, output_nc=4)
CASES = {
    "prelu_0.37": dict(activation="prelu"),
    "prelu_-0.11": dict(activation="prelu", final_act="prelu"),
    "selu": dict(activation="selu"),
    "residual_batch": dict(residual_connection=True),
    "residual_instance": dict(residual_connection=True, norm="instance",
                              pooling="Avg", interp="trilinear"),
    "residual_none": dict(residual_connection=True, norm="none",
                          activation="lrelu"),
    "replicate": dict(pad_type="replicate"),
    "circular": dict(pad_type="circular", activation="elu"),
    "1d": dict(dimension=1),
    "2d": dict(dimension=2, interp="trilinear", pad_type="replicate"),
}
PRELU = {"prelu_0.37": 0.37, "prelu_-0.11": -0.11}
SIZE = {1: (64,), 2: (32, 32), 3: (16, 16, 16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    got, ref = (np.asarray(t.detach() if torch.is_tensor(t) else t,
                           np.float64) for t in (got, ref))
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _float64(fn, *args):
    """`fn(*args)` with the port's plain path evaluated in float64:
    inside, `Tensor.float()` and `torch.float32` mean float64 and factories
    make float64 (`tests/test_torch_segmentation.py`'s witness)."""
    default = torch.get_default_dtype()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "float", torch.Tensor.double)
        mp.setattr(torch, "float32", torch.float64)
        torch.set_default_dtype(torch.float64)
        try:
            return fn(*args)
        finally:
            torch.set_default_dtype(default)


_MODELS: dict = {}


def _model(name):
    """JAX's plan and seeded weights (PReLU weights set, batch norms with
    non-trivial running statistics), the port's plan and state dict, a
    seeded input of batch 2, and the taps: the block ends of the deepest
    encoder level and of the first decoder level."""
    if name in _MODELS:
        return _MODELS[name]
    kw = dict(TINY, **CASES[name])
    jplan = ju.build_plan(ju.UnetConfig(**kw))
    plan = pu.build_plan(pu.UnetConfig(**kw))
    # the port's seeded init carried to JAX (JAX's own eager init compiles
    # for tens of seconds on the CPU)
    params = to_jax_params(plan, pu.init_params(
        plan, torch.Generator().manual_seed(1)))
    for key in ("prelu", "final_prelu"):
        if key in params:
            params[key]["w"] = np.float32([PRELU[name]])
    rng = np.random.default_rng(3)
    for k, p in params.items():
        if isinstance(p, dict) and "mean" in p:
            p["mean"] = rng.normal(0, 0.3, p["mean"].shape).astype(
                np.float32)
            p["var"] = rng.uniform(0.5, 2, p["var"].shape).astype(np.float32)
    sd = from_jax_params(plan, params)
    x = np.random.default_rng(4).standard_normal(
        (2, *SIZE[jplan.config.dimension], 1)).astype(np.float32)
    taps = (plan.encoder_idx[-1], plan.res_dest[-3])
    _MODELS[name] = dict(jplan=jplan, params=params, plan=plan, sd=sd, x=x,
                         taps=taps)
    return _MODELS[name]


_FWD: dict = {}


def _jax_forward(name):
    """JAX's inference output and taps, once per case."""
    if name not in _FWD:
        m = _model(name)
        out, taps = jax.jit(lambda p, x: ju.unet_apply(
            m["jplan"], p, x, layers=m["taps"]))(m["params"],
                                                 jnp.asarray(m["x"]))
        _FWD[name] = (np.asarray(out), [np.asarray(t) for t in taps])
    return _FWD[name]


@pytest.mark.parametrize("name", list(CASES))
def test_eager_forward_and_taps_match_jax(name):
    m = _model(name)
    ref, rtaps = _jax_forward(name)
    net = pu.Unet.from_state_dict(m["plan"], m["sd"])
    with torch.no_grad():
        out, taps = net(torch.from_numpy(m["x"]), layers=m["taps"])
    assert out.shape == ref.shape and _rel(out, ref) <= 1e-5
    for got, r in zip(taps, rtaps):
        assert got.shape == r.shape and _rel(got, r) <= 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_fused_forward_matches_jax(name):
    """The fused walk (batch norms folded where that is exact, residual
    blocks on the norm-apply pass, PReLU's slope from its weight, lifted
    nets on 27-tap kernels with zero taps) in f32 on the CPU."""
    m = _model(name)
    ref, _ = _jax_forward(name)
    fplan, fsd = fold_batchnorm(m["plan"], m["sd"])
    packed = prepack_fused(fplan, fsd, device="cpu",
                           compute_dtype=torch.float32)
    got = unet_apply_fused(fplan, packed, torch.from_numpy(m["x"]),
                           compute_dtype=torch.float32)
    assert got.shape == ref.shape and _rel(got, ref) <= 1e-5


GRAD_CASES = ["prelu_0.37", "prelu_-0.11", "selu", "residual_batch",
              "residual_instance", "replicate", "circular", "1d", "2d"]


class _Float64Names:
    """A numpy-like module with `float32` read as `float64`: the JAX
    package's norm, pool and resize modules cast to `jnp.float32` by name,
    so with this in their place (and x64 on) `unet_apply` runs in float64
    throughout; in the port's `convert` it keeps JAX's float64 gradients
    float64 on their way to the port's names."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(self._module, "float64" if name == "float32" else name)


def _jax_train_vjp64(m, dy):
    """`jax.vjp` of `unet_apply(train=True, conv_impl="xla")` in float64:
    the output, the new running stats and the gradient of every parameter
    for the cotangent `dy` (zero on the stats). In f32 the JAX package is
    no reference at 1e-4 here: its batch norm takes the variance as
    E[x^2] - E[x]^2, and the rounding that leaves moves a few voxels across
    an activation's kink, which shifts a norm's bias gradient by up to 8e-2
    of its scale (its weight gradient, where such voxels weigh x-hat ~ 0,
    by 1e-6); the port takes the two-pass variance."""
    from anatomix_tpu.ops import norms, pool, resize

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for mod in (norms, pool, resize):
            mp.setattr(mod, "jnp", _Float64Names(jnp))
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), m["params"])
        x = jnp.asarray(m["x"].astype(np.float64))

        @jax.jit
        def fwd_bwd(p):
            (out, st), vjp = jax.vjp(
                lambda q: ju.unet_apply(m["jplan"], q, x, train=True), p)
            (g,) = vjp((jnp.asarray(dy.astype(np.float64)),
                        jax.tree_util.tree_map(jnp.zeros_like, st)))
            return out, st, g

        out, stats, grads = jax.tree_util.tree_map(np.asarray,
                                                   fwd_bwd(params))
    assert out.dtype == np.float64
    return out, stats, grads


@pytest.mark.parametrize("name", GRAD_CASES)
def test_train_walk_and_gradients_match_jax(name):
    """The train walk's output, new running stats and the gradient of every
    parameter (a cotangent from numpy) against `jax.vjp` of
    `unet_apply(train=True)`, evaluated in float64 (`_jax_train_vjp64`).
    The port's walk in float64 computes the same function: output, stats
    and every gradient within 1e-9 of JAX's. The port's walk in f32: the
    output within 1e-5, each gradient leaf within 1e-4 of its scale or
    1e-6 of the network's largest gradient (the conv biases before an
    instance norm, which the norm cancels but for the residual's share).
    The PReLU weight is one leaf, whose gradient sums over the act
    slots."""
    m = _model(name)
    plan = m["plan"]
    assert train_block_eligible(plan) == name.startswith(("prelu", "selu"))
    dy = np.random.default_rng(6).standard_normal(
        (2, *SIZE[plan.config.dimension], TINY["output_nc"])).astype(
        np.float32)
    ref, jstats, jgrads = _jax_train_vjp64(m, dy)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert_module, "np", _Float64Names(np))
        ref_g = {k: v.numpy() for k, v in pu.trainable_state(
            plan, from_jax_params(plan, jgrads)).items()}
    for k in [k for k in ref_g
              if k.endswith(("running_mean", "running_var"))]:
        assert not ref_g.pop(k).any()
    assert all(g.dtype == np.float64 for g in ref_g.values())

    def port(dtype):
        params = {k: v.detach().to(dtype).requires_grad_()
                  for k, v in pu.trainable_state(plan, m["sd"]).items()}
        out, _, stats = unet_train_forward(
            plan, params, torch.from_numpy(m["x"]).to(dtype),
            compute_dtype=torch.float32)
        keys = [k for k in params
                if not k.endswith(("running_mean", "running_var"))]
        grads = torch.autograd.grad(out, [params[k] for k in keys],
                                    torch.from_numpy(dy).to(dtype))
        return out, stats, dict(zip(keys, grads))

    net = max(float(np.abs(g).max()) for g in ref_g.values())
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, None)):
        out, stats, grads = (_float64(port, dtype) if dtype == torch.float64
                             else port(dtype))
        assert out.dtype == dtype and sorted(grads) == sorted(ref_g)
        assert _rel(out, ref) <= (tol or 1e-5)
        for idx, (mean, var) in stats.items():
            assert _rel(mean, jstats[idx][0]) <= (tol or 1e-5)
            assert _rel(var, jstats[idx][1]) <= (tol or 1e-5)
        for k, g in grads.items():
            r = ref_g[k]
            scale = float(np.abs(r).max())
            floor = (max(tol * scale, tol * 1e-2 * net) if tol
                     else max(1e-4 * scale, 1e-6 * net))
            assert float(np.abs(g.numpy() - r).max()) <= floor, (dtype, k)
    key = pu.prelu_key(plan)
    if key is not None:
        assert sum(k.endswith(".weight") and g.shape == (1,)
                   for k, g in grads.items()) == 1 + (
            pu.final_prelu_key(plan) is not None)
        assert float(np.abs(ref_g[key]).max()) > 0


def test_two_training_steps_keep_the_prelu_slots_one_weight():
    """`build_all(PretrainConfig(actG="prelu"))`, the launcher's own
    option, takes two steps on the CPU: the PReLU weight is one leaf of
    `params_g`, AdamW moves it, and the reference layout repeats it at
    every act slot, as JAX's one `params["prelu"]["w"]`."""
    from anatomix_tpu_torch.pretraining.config import PretrainConfig
    from anatomix_tpu_torch.pretraining.train import build_all

    cfg = PretrainConfig(actG="prelu", ngf=4, num_downs=2, crop_size=8,
                         nce_layers=(17, 20, 24, 31, 37), netF_nc=16,
                         num_patches=64)
    plan, _, state, step = build_all(cfg, 1, device="cpu")
    key = pu.prelu_key(plan)
    slots = pu.act_slots(plan)
    assert len(slots) > 1 and key in state.params_g
    assert not any(f"model.{i}.weight" in state.params_g for i in slots[1:])
    rng = np.random.default_rng(2)
    views = rng.standard_normal((2, 2, 8, 8, 8, 1)).astype(np.float32)
    segs = rng.integers(0, 3, (2, 8, 8, 8, 1)).astype(np.int32)
    w0 = float(state.params_g[key])
    for _ in range(2):
        state, metrics = step(state, views, segs,
                              torch.Generator().manual_seed(0))
        assert np.isfinite(float(metrics["loss"]))
    w = float(state.params_g[key])
    assert w != w0
    full = pu.untie_prelu(plan, state.params_g)
    assert {float(full[f"model.{i}.weight"]) for i in slots} == {w}
    jax_tree = to_jax_params(plan, state.params_g)
    assert float(jax_tree["prelu"]["w"][0]) == np.float32(w)


@pytest.mark.parametrize("name", ["prelu_-0.11", "2d", "1d"])
def test_convert_round_trip_matches_jax(name):
    """The reference `.pth` layout (the shared PReLU weight at every act
    slot, `nn.Conv1d` / `nn.Conv2d` weights) -> the JAX pytree through the
    port (`check_state_dict`, `to_jax_params`) equals the JAX package's
    `convert_state_dict`, and comes back through `from_jax_params`; unequal
    act slots are refused, as in JAX."""
    m = _model(name)
    plan, sd = m["plan"], m["sd"]
    if plan.config.dimension < 3:
        assert sd["model.0.weight"].dim() == 2 + plan.config.dimension
    check_state_dict(plan, sd)
    ref = jax_convert.convert_state_dict(m["jplan"], {
        k: v.numpy() for k, v in sd.items()})
    got = to_jax_params(plan, sd)
    assert sorted(got) == sorted(ref)
    for k in ref:
        for leaf in ref[k]:
            np.testing.assert_array_equal(got[k][leaf], ref[k][leaf])
    back = from_jax_params(plan, got)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    key = pu.prelu_key(plan)
    if key is not None:
        bad = dict(sd)
        bad[f"model.{pu.act_slots(plan)[-1]}.weight"] = torch.full((1,), 0.5)
        with pytest.raises(ValueError, match="PReLU"):
            check_state_dict(plan, bad)


def test_f10_residual_batch_norm_features_are_the_networks():
    """ROADMAP F10: the residual adds each block's raw conv output, so a
    batch norm whose conv is a residual source cannot fold. The port's
    extractor (`full`, the kernels' plain versions in f32) gives JAX's
    unfolded `unet_apply` within 1e-5; the JAX package's folded plan
    (`extract.fold_batchnorm`, what its extractor runs by default) lands
    far from it."""
    m = _model("residual_batch")
    x = m["x"][:1]
    ref = np.asarray(jax.jit(lambda p, v: ju.unet_apply(m["jplan"], p, v))(
        m["params"], jnp.asarray(x)))
    fplan, fparams = jax_fold_batchnorm(m["jplan"], m["params"])
    folded = np.asarray(jax.jit(lambda p, v: ju.unet_apply(fplan, p, v))(
        fparams, jnp.asarray(x)))
    extract = make_feature_extractor(m["plan"], m["sd"], strategy="full",
                                     device="cpu",
                                     compute_dtype=torch.float32)
    got = extract(x)
    assert _rel(got, ref) <= 1e-5
    assert _rel(folded, ref) > 1e-2
