"""The ViT slice of the port (the 26M `anatomix-dev-vit` Primus v2) against
the JAX package on the CPU, on the same numpy inputs and weights
(`from_jax_primus_params`).

Per module: the channel norms, the tokenizer (against `_tokenizer_v2`, the
JAX CPU path, and `_tokenizer_v2_fused` with its Pallas kernels in
interpret mode), the decoder tower (against `_decoder`, block-space in
interpret mode and stage-wise in XLA). Then the slice as a whole:
`primus_apply` with 5-D and 4-D input, the sliding-window extractor against
JAX `make_feature_extractor`, the registry variant's `.npz` and `.pth`
through `load_from_hf` and the CLI, and the full config's parameter tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomix_tpu import extract as jax_extract
from anatomix_tpu.models.vit3d import convert as jax_convert
from anatomix_tpu.models.vit3d import primus as jax_primus
from anatomix_tpu.ops import norms as jax_norms
from anatomix_tpu.utils.checkpoint import save_pytree
from anatomix_tpu_torch import extract
from anatomix_tpu_torch.extract_cli import main as cli_main
from anatomix_tpu_torch.models import registry
from anatomix_tpu_torch.models.load import load_from_hf
from anatomix_tpu_torch.models.vit3d import (
    Primus,
    PrimusConfig,
    from_jax_primus_params,
    init_primus_params,
    primus_apply,
    primus_config,
    primus_param_count,
)
from anatomix_tpu_torch.models.vit3d.primus import _PLAIN
from anatomix_tpu_torch.ops import norms

NORM_TOL = 1e-5    # relative to max |ref|, f32
TOK_TOL = 1e-4     # f32 convs in another order through 7 instance norms
FUSED_TOL = 1e-3   # JAX's own bound for its fused tokenizer vs XLA
DEC_TOL = 1e-5     # f32 GEMMs, LayerNorm and GELU
MODEL_TOL = 1e-3   # f32 forwards through tokenizer, 2 blocks and decoder
BF16_TOL = 3e-2    # mean|err|/std, the bf16 path's bound (PERF.md)

# the small config of the ViT tests: the registry variant's options at
# input 32^3, embed 64, 2 blocks, 2 heads, 2 registers
SMALL = dict(
    input_channels=1, num_classes=32, embed_dim=64, eva_depth=2,
    eva_numheads=2, patch_embed_size=(8, 8, 8), input_shape=(32, 32, 32),
    num_register_tokens=2, init_values=0.1, scale_attn_inner=True,
    qk_norm=True, out_norm="demean", out_norm_eps=1e-2,
    register_init_std=0.02, in_eps=1e-2,
)


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _randn(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _models(seed=0, **overrides):
    """(JAX config, JAX params with numpy leaves, port config, port state
    dict) on the same weights."""
    kw = dict(SMALL, **overrides)
    jcfg = jax_primus.PrimusConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax_primus.init_primus_params(jcfg, jax.random.PRNGKey(seed)))
    cfg = PrimusConfig(**kw)
    return jcfg, params, cfg, from_jax_primus_params(cfg, params)


@pytest.fixture(scope="module")
def small():
    return _models()


# -----------------------------------------------------------------------------
# modules

def test_channel_norms_match_jax():
    x = _randn(0, (2, 4, 5, 6, 24), 2.0, 0.7)
    ref = jax_norms.channel_layer_norm(jnp.asarray(x), eps=1e-6)
    got = norms.channel_layer_norm(torch.from_numpy(x), eps=1e-6)
    assert _rel(got, ref) < NORM_TOL
    ref = jax_norms.channel_demean(jnp.asarray(x))
    got = norms.channel_demean(torch.from_numpy(x))
    assert _rel(got, ref) < NORM_TOL


@pytest.mark.parametrize("base", [16, 32])
def test_tokenizer_matches_jax(base):
    """The port's tokenizer (plain versions, f32) against `_tokenizer_v2`
    (the JAX CPU path, the correct reference: F1) and `_tokenizer_v2_fused`
    (Pallas K1, V2, D1 in interpret mode)."""
    jcfg, params, cfg, sd = _models(tokenizer_base_features=base)
    x = _randn(1, (1, 32, 32, 32, 1), 0.3, 0.5)
    model = Primus.from_state_dict(cfg, sd, device="cpu")
    with torch.no_grad():
        got = model._tokenizer(torch.from_numpy(x), model._pack(torch.float32),
                               _PLAIN, torch.float32)
    tok = jax.tree_util.tree_map(jnp.asarray, params["tokenizer"])
    ref = jax_primus._tokenizer_v2(jcfg, tok, jnp.asarray(x),
                                   compute_dtype=jnp.float32)
    assert got.shape == ref.shape == (1, 4, 4, 4, 64)
    assert _rel(got, ref) < TOK_TOL
    if base == 16:  # one interpret-mode run of the fused tokenizer
        fused = jax_primus._tokenizer_v2_fused(
            jcfg, tok, jnp.asarray(x), compute_dtype=jnp.float32)
        assert _rel(got, fused) < FUSED_TOL


@pytest.mark.parametrize("out_norm", ["demean", "none"])
def test_decoder_matches_jax(out_norm):
    """The block-space decoder with V1's exit: with `demean` against JAX's
    block-space `_decoder(fuse_demean=True)` (Pallas `depth_to_space8` in
    interpret mode) and against `channel_demean` of the XLA stage path;
    without, the final bias rides the exit's subtract."""
    jcfg, params, cfg, sd = _models(out_norm=out_norm)
    grid = _randn(2, (2, 2, 2, 2, 64))
    dec = jax.tree_util.tree_map(jnp.asarray, params["decoder"])
    model = Primus.from_state_dict(cfg, sd, device="cpu")
    with torch.no_grad():
        got = model._decoder(torch.from_numpy(grid),
                             model._pack(torch.float32), _PLAIN,
                             torch.float32)
    assert got.shape == (2, 16, 16, 16, 32)
    stage, demeaned, _ = jax_primus._decoder(
        jcfg, dec, jnp.asarray(grid), compute_dtype=jnp.float32)
    assert not demeaned
    if out_norm == "demean":
        block, demeaned, _ = jax_primus._decoder(
            jcfg, dec, jnp.asarray(grid), compute_dtype=jnp.float32,
            fuse_demean=True, interpret=True)
        assert demeaned
        assert _rel(got, block) < DEC_TOL
        stage = jax_norms.channel_demean(stage)
    assert _rel(got, stage) < DEC_TOL


# -----------------------------------------------------------------------------
# the slice as a whole

def test_primus_apply_matches_jax(small):
    """The whole forward, f32 plain versions, 5-D and 4-D input, against
    JAX `primus_apply` on the CPU; the bf16 emulation of the card's
    kernels stays under the bf16 bound."""
    jcfg, params, cfg, sd = small
    x = _randn(3, (2, 32, 32, 32, 1), 0.3, 0.5)
    ref = jax_primus.primus_apply(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        compute_dtype=jnp.float32)
    got = primus_apply(cfg, sd, torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 32, 32) and got.dtype == torch.float32
    assert _rel(got, ref) < MODEL_TOL
    got4 = primus_apply(cfg, sd, torch.from_numpy(x[..., 0]))
    torch.testing.assert_close(got4, got, rtol=0, atol=0)
    bf16 = primus_apply(cfg, sd, torch.from_numpy(x),
                        compute_dtype=torch.bfloat16)
    err = ((bf16 - got).abs().mean() / got.std()).item()
    assert err < BF16_TOL, err
    with pytest.raises(ValueError, match="bound to input_shape"):
        primus_apply(cfg, sd, torch.zeros((1, 16, 16, 16, 1)))


def _smooth(seed, shape):
    """A smooth field in [0, 1] (Gaussian blobs, no noise), (B, S, S, S,
    1), as `chip_smoke.py`'s `smooth_field`."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(-1, 1, shape[1])
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    vols = []
    for _ in range(shape[0]):
        v = np.zeros(z.shape)
        for c, w in zip(rng.uniform(-0.8, 0.8, (8, 3)),
                        rng.uniform(0.05, 0.25, 8)):
            v += np.exp(-((z - c[0]) ** 2 + (y - c[1]) ** 2
                          + (x - c[2]) ** 2) / w)
        vols.append((v - v.min()) / (v.max() - v.min()))
    return np.stack(vols)[..., None].astype(np.float32)


def test_stages_match_jax_on_smooth_input(small):
    """P1: on a smooth input, the port's f32 stage outputs (`record`: the
    tokenizer grid, each block's residual stream, the final norm, the exit)
    against JAX's (`_tokenizer_v2`, its EVA block loop, `primus_apply`);
    and the bf16 path, whose tokenizer reads every conv operand through the
    three-term split, within 1e-3 of f32 at the tokenizer and under the
    bf16 bound at the exit."""
    jcfg, params, cfg, sd = small
    x = _smooth(8, (2, 32, 32, 32, 1))
    model = Primus.from_state_dict(cfg, sd, device="cpu")
    rec, rec_bf16 = {}, {}
    with torch.no_grad():
        got = model(torch.from_numpy(x), compute_dtype=torch.float32,
                    plain=True, record=lambda n, t: rec.__setitem__(n, t))
        bf16 = model(torch.from_numpy(x),
                     record=lambda n, t: rec_bf16.__setitem__(n, t))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    f32 = jnp.float32
    grid = jax_primus._tokenizer_v2(jcfg, jp["tokenizer"], jnp.asarray(x),
                                    compute_dtype=f32)
    assert _rel(rec["tokenizer"], grid) < TOK_TOL
    B, R, E = 2, cfg.num_register_tokens, cfg.embed_dim
    tokens = grid.reshape(B, cfg.num_tokens, E) + jp["pos_embed"]
    tokens = jnp.concatenate([jnp.broadcast_to(jp["register_tokens"],
                                               (B, R, E)), tokens], axis=1)
    rope = jax_primus._rope_tables(jcfg)
    for i, blk in enumerate(jp["blocks"]):
        a = jax_primus._attention(
            jcfg, blk, jax_primus._layer_norm(tokens, blk["norm1"]), rope, R,
            compute_dtype=f32)
        tokens = tokens + a * blk["gamma1"]
        m = jax_primus._mlp(blk, jax_primus._layer_norm(tokens, blk["norm2"]))
        tokens = tokens + m * blk["gamma2"]
        assert _rel(rec[f"block {i}"], tokens) < TOK_TOL
    final = jax_primus._layer_norm(tokens, jp["norm"])[:, R:]
    assert _rel(rec["final norm"], final.reshape(B, 4, 4, 4, E)) < TOK_TOL
    ref = jax_primus.primus_apply(jcfg, jp, jnp.asarray(x),
                                  compute_dtype=f32)
    assert _rel(got, ref) < MODEL_TOL
    tok = rec_bf16["tokenizer"] - rec["tokenizer"]
    assert (tok.abs().mean() / rec["tokenizer"].std()).item() < 1e-3
    err = ((bf16 - got).abs().mean() / got.std()).item()
    assert err < BF16_TOL, err


def test_vit_sliding_extractor_matches_jax(small):
    """Eight 32^3 windows on a 48^3 volume (overlap 0.5, Gaussian), the
    port's f32 extractor against the JAX one; `strategy` is ignored."""
    jcfg, params, cfg, sd = small
    vol = _randn(4, (1, 48, 48, 48, 1), 0.3, 0.5)
    kw = dict(overlap=0.5, sw_batch_size=2)
    ref = jax_extract.make_feature_extractor(
        jcfg, params, compute_dtype=jnp.float32, **kw)(jnp.asarray(vol))
    got = extract.make_feature_extractor(
        cfg, sd, strategy="full", compute_dtype=torch.float32, device="cpu",
        **kw)(vol)
    assert got.shape == (1, 48, 48, 48, 32)
    assert _rel(got, ref) < MODEL_TOL
    eager = extract.make_feature_extractor(cfg, sd, impl="eager",
                                           device="cpu", **kw)(vol)
    assert _rel(eager, got) < 1e-6


def _upstream_state_dict(cfg, rng):
    """A state dict in the upstream layout (the converter's key map: timm
    EVA names under `eva.`, numbered convs in `down_projection` /
    `up_projection`)."""
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    d, hd, hid = cfg.embed_dim, cfg.head_dim, cfg.mlp_hidden
    sd = {"eva.pos_embed": t(1, cfg.num_tokens, d),
          "register_tokens": t(1, cfg.num_register_tokens, d),
          "eva.norm.weight": t(d) + 1, "eva.norm.bias": t(d)}
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
    convs = [(cfg.tokenizer_base_features, cfg.input_channels, 3)]
    ch = cfg.tokenizer_base_features
    for _ in range(3):
        out = min(2 * ch, cfg.embed_dim)
        convs += [(out, ch, 3), (out, out, 3), (out, out, 3)]
        ch = out
    convs.append((cfg.embed_dim, ch, 1))
    for i, (o, c, k) in enumerate(convs):
        sd[f"down_projection.encoder.{i}.weight"] = t(o, c, k, k, k)
        sd[f"down_projection.encoder.{i}.bias"] = t(o)
    ch = cfg.embed_dim
    for i in range(3):
        out = cfg.num_classes if i == 2 else max(ch // 2, 32)
        sd[f"up_projection.decode.{i}.weight"] = t(ch, out, 2, 2, 2)
        sd[f"up_projection.decode.{i}.bias"] = t(out)
        ch = out
    return sd


def test_load_from_hf_npz_and_pth(small, tmp_path, monkeypatch):
    """`load_from_hf("anatomix-dev-vit", cache_path=...)` on files the test
    writes (the registry entry cut to the small config): the JAX
    `save_pytree` `.npz` gives the JAX weights exactly; an upstream-layout
    `.pth` converts as the JAX converter does and runs as JAX runs it. The
    CLI extracts with it on the CPU."""
    jcfg, params, cfg, sd = small
    monkeypatch.setitem(registry.ANATOMIX_VARIANTS["anatomix-dev-vit"],
                        "vit_kwargs", dict(SMALL))
    npz = str(tmp_path / "vit.npz")
    save_pytree(npz, params)
    got_cfg, got_sd = load_from_hf("anatomix-dev-vit", npz, device="cpu")
    assert got_cfg == cfg and got_sd.keys() == sd.keys()
    for k in sd:
        torch.testing.assert_close(got_sd[k], sd[k], rtol=0, atol=0)

    upstream = _upstream_state_dict(cfg, np.random.default_rng(5))
    pth = str(tmp_path / "vit.pth")
    torch.save(upstream, pth)
    _, pth_sd = load_from_hf("anatomix-dev-vit", pth, device="cpu")
    jparams, unmapped, unfilled = jax_convert.convert_primus_state_dict(
        jcfg, upstream)
    assert unmapped == [] and unfilled == []
    x = _randn(6, (1, 32, 32, 32, 1), 0.3, 0.5)
    ref = jax_primus.primus_apply(
        jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(x),
        compute_dtype=jnp.float32)
    got = primus_apply(cfg, pth_sd, torch.from_numpy(x))
    assert _rel(got, ref) < MODEL_TOL
    upstream["eva.extra.weight"] = torch.zeros(3)
    torch.save(upstream, pth)
    with pytest.raises(ValueError, match="eva.extra.weight"):
        load_from_hf("anatomix-dev-vit", pth, device="cpu")

    vol = tmp_path / "v.npy"
    np.save(vol, _randn(7, (36, 32, 40), 100.0))
    out = tmp_path / "f.npz"
    cli_main(["--input", str(vol), "--output", str(out), "--hf_variant",
              "anatomix-dev-vit", "--cache_path", npz, "--device", "cpu",
              "--dtype", "float32", "--overlap", "0.5"])
    feats = np.load(out)["features"]
    assert feats.shape == (36, 32, 40, 32) and np.isfinite(feats).all()


def test_full_config_parameter_tree():
    """The registry variant at full width and depth: the port's module has
    the JAX pytree's leaves, shapes and count (~31M), and its seeded init
    draws them."""
    kw = registry.ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"]
    cfg = primus_config(kw)
    jcfg = jax_primus.PrimusConfig(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()})
    shapes = jax.eval_shape(
        lambda: jax_primus.init_primus_params(jcfg, jax.random.PRNGKey(0)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape)
            for k, v in from_jax_primus_params(cfg, zeros).items()}
    model = Primus(cfg, device="meta")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert cfg.head_dim == 66 and cfg.mlp_hidden == 1056
    assert cfg.num_tokens + cfg.num_register_tokens == 4104
    assert primus_param_count(model.state_dict()) == n
    assert 20e6 < n < 33e6
    small_cfg = PrimusConfig(**SMALL)
    a = init_primus_params(small_cfg, torch.Generator().manual_seed(3))
    b = init_primus_params(small_cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["blocks.0.gamma1"][0]) == pytest.approx(0.1)
