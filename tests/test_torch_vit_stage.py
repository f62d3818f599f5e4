"""The ViT's stage-wise decoder, fold exit and v1 patch-embed tokenizer in
the port, against the JAX package on the CPU, on the same numpy inputs and
weights (`from_jax_primus_params`).

Per module: the plain versions of the three layout kernels
(`depth_to_space_fold_ndhwc`, `depth_to_space_interleave_ndhwc`,
`space_to_depth_c1_ndhwc`) against JAX's Pallas kernels in interpret mode;
the stage-wise decoder against JAX's `_decoder` (fold and spatial emits,
demean and not). Then the slice as a whole: v1 `primus_apply` at patch 8
and 4 against JAX's, the sliding extractor's fold route against JAX's
extractor and against the block-space route of the same port model, and
the v1 `.pth` conversion against the JAX converter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu import extract as jax_extract
from anatomix_tpu.models.vit3d import convert as jax_convert
from anatomix_tpu.models.vit3d import primus as jax_primus
from anatomix_tpu.ops.pallas import reshuffle as jax_reshuffle
from anatomix_tpu_torch import extract
from anatomix_tpu_torch.kernels import reshuffle as kr
from anatomix_tpu_torch.models.vit3d import (
    Primus,
    PrimusConfig,
    convert_primus_state_dict,
    from_jax_primus_params,
    primus_apply,
)
from anatomix_tpu_torch.models.vit3d import primus as port_primus
from anatomix_tpu_torch.ops.sliding_window import sliding_window_inference

DEC_TOL = 1e-5     # f32 GEMMs, LayerNorm and GELU in another order
V1_MEAN_TOL = 1e-5  # mean|err|/std, f32 v1 forward (embed 64, 2 blocks)
V1_MAX_TOL = 1e-4   # max|err| / max|ref|, the same forward
SLIDE_TOL = 1e-3   # the f32 extractor through 8 windows (test_torch_vit)

# the v1 config of these tests: the registry ViT's options at input 32^3,
# embed 64, 2 blocks, 2 heads, 2 registers
SMALL_V1 = dict(
    input_channels=1, num_classes=32, embed_dim=64, eva_depth=2,
    eva_numheads=2, patch_embed_size=(8, 8, 8), input_shape=(32, 32, 32),
    num_register_tokens=2, init_values=0.1, scale_attn_inner=True,
    qk_norm=True, out_norm="demean", out_norm_eps=1e-2,
    register_init_std=0.02, in_eps=1e-2, version="v1",
)
_DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
       "f32": (torch.float32, jnp.float32)}


def _randn(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32), np.float64)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _mean_rel(got, ref):
    got, ref = _np(got), _np(ref)
    return np.abs(got - ref).mean() / ref.std()


def _models(seed=0, **overrides):
    """(JAX config, JAX params with numpy leaves, port config, port state
    dict) on the same weights."""
    kw = dict(SMALL_V1, **overrides)
    jcfg = jax_primus.PrimusConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray,
        jax_primus.init_primus_params(jcfg, jax.random.PRNGKey(seed)))
    cfg = PrimusConfig(**kw)
    return jcfg, params, cfg, from_jax_primus_params(cfg, params)


# -----------------------------------------------------------------------------
# the three layout kernels' plain versions against the Pallas kernels

@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("with_sub", [False, True])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("which", ["fold", "interleave"])
def test_d2s_exits_match_pallas(which, C, with_sub, dtype):
    """Exact: both move the same values and subtract the same f32 numbers
    (atol 0), bf16 or f32 in and out."""
    tdt, jdt = _DT[dtype]
    B, d = 2, 8
    y = _randn(1, (B, d, d, d, 8 * C))
    sub = _randn(2, (B, 8 * C)) if with_sub else None
    yj = jnp.asarray(y).astype(jdt)
    yt = torch.from_numpy(y).to(tdt)
    fn = {"fold": jax_reshuffle.depth_to_space_fold,
          "interleave": jax_reshuffle.depth_to_space_interleave}[which]
    ref = fn(yj, sub=None if sub is None else jnp.asarray(sub),
             out_dtype=jdt, interpret=True)
    port = {"fold": kr.depth_to_space_fold_ndhwc,
            "interleave": kr.depth_to_space_interleave_ndhwc}[which]
    got = port(yt, None if sub is None else torch.from_numpy(sub),
               out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_space_to_depth_c1_matches_pallas(dtype):
    """Exact (atol 0), in JAX's `space_to_depth_4d` lane order."""
    tdt, jdt = _DT[dtype]
    x = _randn(3, (2, 16, 12, 8))
    ref = jax_reshuffle.space_to_depth_c1(jnp.asarray(x).astype(jdt),
                                          interpret=True)
    got = kr.space_to_depth_c1_ndhwc(torch.from_numpy(x).to(tdt))
    assert got.shape == (2, 8, 6, 4, 8) and got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_fold_raises_outside_envelope():
    """The fold exit's envelope is JAX's `fold_supported`: outside it the
    wrapper raises, on every device."""
    assert kr.fold_supported(32, 2) and not kr.fold_supported(32, 3)
    assert not kr.fold_supported(48, 4)
    with pytest.raises(ValueError, match="fold unsupported"):
        kr.depth_to_space_fold_ndhwc(torch.zeros((1, 2, 2, 3, 8 * 32)))


# -----------------------------------------------------------------------------
# the stage-wise decoder

def _stage_decoder(out_norm):
    """The shapes of tests/test_vit3d.py test_decoder_fused_demean: two
    stages 24 -> 16 -> 8 on a (2, 4^3, 24) grid; JAX's layer list and the
    port's packed GEMMs (ci, 8 co) of the same weights."""
    rng = np.random.default_rng(3)
    dec, packs, ch = [], [], 24
    for co in (16, 8):
        w = rng.standard_normal((2, 2, 2, ch, co)).astype(np.float32) * 0.1
        b = rng.standard_normal((co,)).astype(np.float32)
        dec.append({"w": jnp.asarray(w), "b": jnp.asarray(b)})
        packs.append((torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 0, 1, 2, 4).reshape(ch, 8 * co))),
            torch.from_numpy(b)))
        ch = co
    grid = rng.standard_normal((2, 4, 4, 4, 24)).astype(np.float32)
    model = Primus(PrimusConfig(**dict(SMALL_V1, out_norm=out_norm)),
                   device="cpu")
    return dec, {"dec": packs}, grid, model


@pytest.mark.parametrize("emit", ["fold", "spatial"])
@pytest.mark.parametrize("out_norm", ["demean", "none"])
def test_stage_decoder_matches_jax(out_norm, emit):
    """The port's stage path (f32 plain versions) against JAX `_decoder`
    with the Pallas kernels in interpret mode (`fuse_demean`: the fold exit
    for emit='fold', the subtracting depth_to_space for 'spatial'), and
    without demean against the XLA stage path; rel 1e-5."""
    dec, p, grid, model = _stage_decoder(out_norm)
    calls = []
    ops = port_primus._PLAIN
    spy = dict(vars(ops))
    for name in ("fold", "interleave", "d2s2", "d2s8"):
        spy[name] = (lambda fn, name: lambda *a, **k: (
            calls.append(name), fn(*a, **k))[1])(getattr(ops, name), name)
    with torch.no_grad():
        got = model._decoder(torch.from_numpy(grid), p,
                             type(ops)(**spy), torch.float32, emit=emit)
    demean = out_norm == "demean"
    ref, demeaned, folded = jax_primus._decoder(
        None, dec, jnp.asarray(grid), compute_dtype=jnp.float32,
        fuse_demean=demean, interpret=demean, emit=emit)
    assert demeaned == demean and folded == (demean and emit == "fold")
    want_exit = {"fold": "fold", "spatial": "interleave"}[emit]
    assert calls == ["d2s2"] + ([want_exit] if demean else ["d2s2"])
    if not demean and emit == "fold":
        ref = ref.reshape(2, 16, 16, 16 * 8 // 128, 128)
    assert tuple(got.shape) == tuple(ref.shape)
    assert _rel(got, ref) < DEC_TOL


# -----------------------------------------------------------------------------
# the v1 model as a whole

@pytest.mark.parametrize("patch", [8, 4])
def test_v1_primus_apply_matches_jax(patch):
    """v1 (the patch-embed conv + token LayerNorm) at patch 8 (three
    decoder stages: the block-space decoder for the spatial emit) and 4 (two
    stages: the stage path and its interleave exit), f32, against JAX
    `primus_apply` on the CPU; the fold emit gives the same bytes."""
    jcfg, params, cfg, sd = _models(patch_embed_size=(patch,) * 3)
    x = _randn(4, (2, 32, 32, 32, 1), 0.3, 0.5)
    ref = jax_primus.primus_apply(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        compute_dtype=jnp.float32)
    got = primus_apply(cfg, sd, torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 32, 32) and got.dtype == torch.float32
    assert _mean_rel(got, ref) < V1_MEAN_TOL
    assert _rel(got, ref) < V1_MAX_TOL
    folded = primus_apply(cfg, sd, torch.from_numpy(x[..., 0]), emit="fold")
    assert folded.shape == (2, 32, 32, 8, 128)
    assert _rel(folded.reshape(got.shape), ref) < V1_MAX_TOL


def test_v1_tokenizer_is_the_strided_conv():
    """The f32 block-layout chain + GEMM + LayerNorm equals torch's stride-p
    conv + LayerNorm, at patch 2, 4 and 16, with 1 and 2 input channels."""
    for patch, ci in ((2, 1), (4, 2), (16, 1)):
        cfg = PrimusConfig(**dict(SMALL_V1, patch_embed_size=(patch,) * 3,
                                  input_channels=ci))
        model = Primus(cfg, device="cpu")
        torch.nn.init.normal_(model.tokenizer.proj.weight,
                              generator=torch.Generator().manual_seed(patch))
        x = torch.from_numpy(_randn(patch, (2, 32, 32, 32, ci)))
        with torch.no_grad():
            got = model._tokenizer_v1(x, model._pack(torch.float32),
                                      port_primus._PLAIN)
            ref = torch.nn.functional.conv3d(
                x.permute(0, 4, 1, 2, 3), model.tokenizer.proj.weight,
                model.tokenizer.proj.bias, stride=patch)
            ref = model.tokenizer.norm(ref.permute(0, 2, 3, 4, 1))
        assert got.shape == (2, *(32 // patch,) * 3, 64)
        assert _rel(got, ref) < 1e-5


def test_v1_config_envelope():
    """v1 takes cubic power-of-two patches of 2 or more that divide the
    input; v2 keeps patch 8^3."""
    for bad in ((8, 8, 4), (6, 6, 6), (1, 1, 1)):
        with pytest.raises(NotImplementedError):
            Primus(PrimusConfig(**dict(SMALL_V1, patch_embed_size=bad)))
    with pytest.raises(NotImplementedError):
        Primus(PrimusConfig(**dict(SMALL_V1, version="v2",
                                   patch_embed_size=(16,) * 3)))
    cfg = PrimusConfig(**dict(SMALL_V1, patch_embed_size=(16,) * 3))
    assert port_primus._decoder_widths(cfg) == [(64, 32), (32, 32),
                                                (32, 32), (32, 32)]
    full = PrimusConfig(**dict(SMALL_V1, embed_dim=396,
                               patch_embed_size=(16,) * 3))
    assert port_primus._decoder_widths(full) == [(396, 198), (198, 99),
                                                 (99, 49), (49, 32)]


# -----------------------------------------------------------------------------
# the sliding extractor's fold route

def test_vit_sliding_fold_route_matches_jax():
    """Eight 32^3 windows on a 48^3 volume (overlap 0.5, Gaussian): the
    port's f32 extractor takes the fold route (its scatter eligibility
    holds: 48 * 32 and 32 * 32 are multiples of 128) and matches JAX's
    extractor (its XLA path on the CPU) and the block-space route of the
    same port model (a window function asking for the spatial emit)."""
    jcfg, params, cfg, sd = _models(version="v2")
    vol = _randn(5, (1, 48, 48, 48, 1), 0.3, 0.5)
    kw = dict(overlap=0.5, sw_batch_size=2)
    ref = jax_extract.make_feature_extractor(
        jcfg, params, compute_dtype=jnp.float32, **kw)(jnp.asarray(vol))
    calls = []
    fold = port_primus._KERNELS.fold
    try:
        port_primus._KERNELS.fold = lambda *a, **k: (
            calls.append(a[0].shape), fold(*a, **k))[1]
        got = extract.make_feature_extractor(
            cfg, sd, compute_dtype=torch.float32, device="cpu", **kw)(vol)
    finally:
        port_primus._KERNELS.fold = fold
    assert len(calls) == 4 and calls[0] == (2, 16, 16, 16, 256)
    assert got.shape == (1, 48, 48, 48, 32)
    assert _rel(got, ref) < SLIDE_TOL
    model = Primus.from_state_dict(cfg, sd, device="cpu")
    with torch.inference_mode():
        block = sliding_window_inference(
            torch.from_numpy(vol), lambda w: model(
                w, compute_dtype=torch.float32, emit="spatial"),
            32, roi_size=cfg.input_shape, **kw)
    assert _rel(got, block) < DEC_TOL


# -----------------------------------------------------------------------------
# the v1 `.pth` conversion

def _upstream_v1_state_dict(cfg, rng):
    """A v1 state dict in the upstream layout: timm EVA names under `eva.`,
    the patch-embed conv and its norm under `down_projection`, the
    transposed convs under `up_projection`."""
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    d, hd, hid = cfg.embed_dim, cfg.head_dim, cfg.mlp_hidden
    p = cfg.patch_embed_size[0]
    sd = {"eva.pos_embed": t(1, cfg.num_tokens, d),
          "register_tokens": t(1, cfg.num_register_tokens, d),
          "eva.norm.weight": t(d) + 1, "eva.norm.bias": t(d),
          "down_projection.proj.weight": t(d, cfg.input_channels, p, p, p),
          "down_projection.proj.bias": t(d),
          "down_projection.norm.weight": t(d) + 1,
          "down_projection.norm.bias": t(d)}
    for i in range(cfg.eva_depth):
        b = f"eva.blocks.{i}"
        for name, shape in [
            ("norm1.weight", (d,)), ("norm1.bias", (d,)),
            ("attn.q_proj.weight", (d, d)), ("attn.q_bias", (d,)),
            ("attn.k_proj.weight", (d, d)), ("attn.v_proj.weight", (d, d)),
            ("attn.v_bias", (d,)), ("attn.proj.weight", (d, d)),
            ("attn.proj.bias", (d,)), ("attn.q_norm.weight", (hd,)),
            ("attn.q_norm.bias", (hd,)), ("attn.k_norm.weight", (hd,)),
            ("attn.k_norm.bias", (hd,)), ("attn.norm.weight", (d,)),
            ("attn.norm.bias", (d,)), ("gamma_1", (d,)), ("gamma_2", (d,)),
            ("norm2.weight", (d,)), ("norm2.bias", (d,)),
            ("mlp.w1.weight", (hid, d)), ("mlp.w1.bias", (hid,)),
            ("mlp.w2.weight", (hid, d)), ("mlp.w2.bias", (hid,)),
            ("mlp.w3.weight", (d, hid)), ("mlp.w3.bias", (d,)),
        ]:
            sd[f"{b}.{name}"] = t(*shape)
    for i, (ci, co) in enumerate(port_primus._decoder_widths(cfg)):
        sd[f"up_projection.decode.{i}.weight"] = t(ci, co, 2, 2, 2)
        sd[f"up_projection.decode.{i}.bias"] = t(co)
    return sd


@pytest.mark.parametrize("patch", [8, 16])
def test_v1_pth_conversion_matches_jax(patch):
    """The port's converter and JAX's give the same pytree from an upstream
    v1 state dict (n_up = log2(patch) decoder stages), both with nothing
    unmapped or unfilled, and the port runs it as JAX does."""
    kw = dict(SMALL_V1, patch_embed_size=(patch,) * 3)
    cfg, jcfg = PrimusConfig(**kw), jax_primus.PrimusConfig(**kw)
    upstream = _upstream_v1_state_dict(cfg, np.random.default_rng(patch))
    got, unmapped, unfilled = convert_primus_state_dict(cfg, upstream)
    ref, j_unmapped, j_unfilled = jax_convert.convert_primus_state_dict(
        jcfg, upstream)
    assert unmapped == j_unmapped == [] and unfilled == j_unfilled == []
    g_leaves, g_tree = jax.tree_util.tree_flatten(got)
    r_leaves, r_tree = jax.tree_util.tree_flatten(ref)
    assert g_tree == r_tree and len(g_leaves) == len(r_leaves)
    for a, b in zip(g_leaves, r_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(got["decoder"]) == int(np.log2(patch))
    if patch == 8:
        x = _randn(6, (1, 32, 32, 32, 1), 0.3, 0.5)
        want = jax_primus.primus_apply(
            jcfg, jax.tree_util.tree_map(jnp.asarray, ref), jnp.asarray(x),
            compute_dtype=jnp.float32)
        out = primus_apply(cfg, from_jax_primus_params(cfg, got),
                           torch.from_numpy(x))
        assert _mean_rel(out, want) < V1_MEAN_TOL
