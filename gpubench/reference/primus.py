"""Plain float32 PyTorch forward of the 26M anatomix-dev-vit ViT, the benchmark's reference.

The network of neel-dey/anatomix `load_from_hf.py`
`ANATOMIX_VARIANTS["anatomix-dev-vit"]`: a `PrimusV2` (Wald et al., 2025,
"Primus", MIC-DKFZ dynamic-network-architectures) with anatomix's
extensions (per-head q/k LayerNorm, the inner attention norm, register
tokens drawn anew, an output norm). Written from that description, one
equation at a time; this module imports nothing of the program under test.

- Tokenizer (v2): a 3x3x3 stem conv, then per stage a 3x3x3 stride-2 conv
  (padding 1) and `depth` residual blocks (conv, norm-act, conv, norm, the
  block's input added, the activation), then a 1x1x1 projection to the
  embedding. Every conv pads with zeros and has a bias; every norm is an
  instance norm (biased variance, eps `in_eps`, no affine) and every
  activation LeakyReLU(0.01). Stage widths double from
  `tokenizer_base_features`, capped at `embed_dim`.
- Tokens: the grid (d, h, w) row-major, the learned absolute position
  embedding added, the register tokens placed first.
- EVA blocks, pre-norm (LayerNorm eps 1e-6 with affine): q, k and v
  projections (k without a bias), a LayerNorm over each head's channels of
  q and k (eps 1e-5), a rotary embedding on the patch tokens alone,
  `softmax(q k^T / sqrt(head_dim)) v` materialized in f32, the inner
  LayerNorm over the merged heads (eps 1e-6), the output projection,
  LayerScale; then the SwiGLU MLP `w3(silu(w1 h) * w2 h)`, LayerScale.
- Rotary embedding: axial over the three grid axes, `(head_dim / 2) // 3`
  frequencies `theta^(-i / n)` an axis; channel pair `(2p, 2p + 1)` is one
  complex number, turned by `coord[axis] * freq`, pairs taken axis by axis
  (D, then H, then W), any pair left over not turned.
- The final LayerNorm (eps 1e-6), the registers dropped, the token grid.
- Decoder: `log2(patch)` transposed convs of kernel 2 and stride 2 (the
  embedding halved each stage, at least 32, the last to `num_classes`), with
  a LayerNorm over the channels (eps 1e-6, no affine) and tanh-GELU between
  stages.
- Output norm `demean`: each channel's mean over the window subtracted.

Departures from upstream, each what the port and the JAX package run:
the decoder's channel LayerNorm has no learned affine; the registers and
the position embedding have the shapes of the configuration's grid (no
interpolation to another input size); only the `demean` output norm is
written, the configuration's.

It runs in NCDHW with `torch.nn.functional` only, TF32 switched off around
it. The weights are the program's state dict (the port's torch layouts and
key names: `parameter_shapes`). `precision` maps parts of `PARTS` to type
names, as the configuration file's `precision` states them. Every part
computes in f32; a part in a narrower type rounds to it what it names, any
product then taken in f32:
- `tokenizer`: each conv's input and weights;
- `residual_stream`: the tokens after the embedding and each residual add;
- `linears`: the input and weights of the q, k, v and output projections;
- `layer_norms`: the output of each EVA LayerNorm (norm1, norm2, q and k,
  the inner and the final norm);
- `rope`: the turned q and k;
- `mlp`: the input and weights of the three SwiGLU linears;
- `attention_qkv`: q, k and v into attention (the probabilities stay f32);
- `decoder`: each transposed conv's input, weights and product, the bias
  added, the channel LayerNorm's and GELU's outputs, and the demeaned
  output (its mean taken in f32).
A part left out of `precision` is f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .unet import no_tf32, round_to

PARTS = ("tokenizer", "residual_stream", "linears", "layer_norms", "rope",
         "mlp", "attention_qkv", "decoder")


def tokenizer_widths(cfg: dict) -> tuple[list[tuple[int, int]], int]:
    """(ci, co) of each stride-2 stage, and the tokenizer's last width."""
    ch, stages = cfg["tokenizer_base_features"], []
    for _ in cfg["tokenizer_depth_per_level"]:
        out = min(2 * ch, cfg["embed_dim"])
        stages.append((ch, out))
        ch = out
    return stages, ch


def decoder_widths(cfg: dict) -> list[tuple[int, int]]:
    """(ci, co) of each transposed conv of the decoder."""
    n = int(round(math.log2(cfg["patch_embed_size"][0])))
    ch, out = cfg["embed_dim"], []
    for i in range(n):
        co = cfg["num_classes"] if i == n - 1 else max(ch // 2, 32)
        out.append((ch, co))
        ch = co
    return out


def grid_shape(cfg: dict) -> tuple[int, int, int]:
    return tuple(s // p for s, p in zip(cfg["input_shape"],
                                        cfg["patch_embed_size"]))


def mlp_hidden(cfg: dict) -> int:
    return int(cfg["embed_dim"] * cfg["mlp_ratio"])


def parameter_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of the state dict, by key."""
    e, ci = cfg["embed_dim"], cfg["input_channels"]
    base = cfg["tokenizer_base_features"]
    hd = e // cfg["eva_numheads"]
    out: dict[str, tuple[int, ...]] = {}

    def conv(key, co, ci, k=3):
        out[f"{key}.weight"] = (co, ci, k, k, k)
        out[f"{key}.bias"] = (co,)

    def linear(key, co, ci, bias=True):
        out[f"{key}.weight"] = (co, ci)
        if bias:
            out[f"{key}.bias"] = (co,)

    def ln(key, c):
        out[f"{key}.weight"] = (c,)
        out[f"{key}.bias"] = (c,)

    stages, last = tokenizer_widths(cfg)
    conv("tokenizer.stem", base, ci)
    for i, ((a, b), depth) in enumerate(zip(
            stages, cfg["tokenizer_depth_per_level"])):
        conv(f"tokenizer.stages.{i}.down", b, a)
        for j in range(depth):
            for name in ("conv1", "conv2"):
                conv(f"tokenizer.stages.{i}.blocks.{j}.{name}", b, b)
    conv("tokenizer.proj", e, last, k=1)
    g = grid_shape(cfg)
    if cfg["use_abs_pos_embed"]:
        out["pos_embed"] = (g[0] * g[1] * g[2], e)
    if cfg["num_register_tokens"] > 0:
        out["register_tokens"] = (cfg["num_register_tokens"], e)
    for i in range(cfg["eva_depth"]):
        k = f"blocks.{i}"
        ln(f"{k}.norm1", e)
        linear(f"{k}.q_proj", e, e)
        linear(f"{k}.k_proj", e, e, bias=False)
        linear(f"{k}.v_proj", e, e)
        linear(f"{k}.proj", e, e)
        if cfg["qk_norm"]:
            ln(f"{k}.q_norm", hd)
            ln(f"{k}.k_norm", hd)
        if cfg["scale_attn_inner"]:
            ln(f"{k}.attn_inner_norm", e)
        if cfg["init_values"] is not None:
            out[f"{k}.gamma1"] = (e,)
            out[f"{k}.gamma2"] = (e,)
        ln(f"{k}.norm2", e)
        linear(f"{k}.mlp_w1", mlp_hidden(cfg), e)
        linear(f"{k}.mlp_w2", mlp_hidden(cfg), e)
        linear(f"{k}.mlp_w3", e, mlp_hidden(cfg))
    ln("norm", e)
    for i, (a, b) in enumerate(decoder_widths(cfg)):
        out[f"decoder.{i}.weight"] = (a, b, 2, 2, 2)
        out[f"decoder.{i}.bias"] = (b,)
    return out


def rotary_angles(cfg: dict, device) -> torch.Tensor:
    """(N, head_dim / 2) float64 angle of each patch token's channel
    pair."""
    hd = cfg["embed_dim"] // cfg["eva_numheads"]
    n = (hd // 2) // 3
    g = grid_shape(cfg)
    freq = torch.tensor([cfg["rope_theta"] ** (-i / max(n, 1))
                         for i in range(n)], dtype=torch.float64)
    t = torch.arange(g[0] * g[1] * g[2])
    coords = (t // (g[1] * g[2]), (t // g[2]) % g[1], t % g[2])
    angles = torch.zeros((len(t), hd // 2), dtype=torch.float64)
    for axis in range(3):
        angles[:, axis * n:(axis + 1) * n] = (
            coords[axis].double()[:, None] * freq)
    return angles.to(device)


def _layer_norm(x, sd, key, eps, dim):
    return F.layer_norm(x, (dim,), sd[f"{key}.weight"].float(),
                        sd[f"{key}.bias"].float(), eps)


def part_dtypes(precision: dict[str, str] | None
                ) -> dict[str, torch.dtype | None]:
    """Each part's rounding type (None for f32), from a map of type names
    as the configuration file's `precision`."""
    precision = precision or {}
    unknown = set(precision) - set(PARTS)
    if unknown:
        raise ValueError(f"unknown parts {sorted(unknown)}; known: {PARTS}")
    out = {}
    for part in PARTS:
        dtype = getattr(torch, precision.get(part, "float32"))
        out[part] = None if dtype == torch.float32 else dtype
    return out


def forward(cfg: dict, sd: dict[str, torch.Tensor], x: torch.Tensor,
            precision: dict[str, str] | None = None) -> torch.Tensor:
    """`x` (B, C, D, H, W) f32 at `input_shape` -> features (B,
    num_classes, D, H, W) f32, each part in its `precision`."""
    if cfg.get("out_norm") != "demean":
        raise NotImplementedError("the reference writes the demean out norm")
    dtypes = part_dtypes(precision)

    def rnd(t, part):
        return round_to(t, dtypes[part])

    def conv(v, key, stride=1, pad=1):
        return F.conv3d(rnd(v, "tokenizer"),
                        rnd(sd[f"{key}.weight"].float(), "tokenizer"),
                        sd[f"{key}.bias"].float(), stride=stride,
                        padding=pad)

    def linear(v, key, part="linears"):
        b = sd.get(f"{key}.bias")
        return F.linear(rnd(v, part), rnd(sd[f"{key}.weight"].float(), part),
                        None if b is None else b.float())

    def layer_norm(v, key, eps, dim):
        return rnd(_layer_norm(v, sd, key, eps, dim), "layer_norms")

    eps = cfg["in_eps"]

    def norm_act(v, residual=None):
        v = F.instance_norm(v, eps=eps)
        if residual is not None:
            v = v + residual
        return F.leaky_relu(v, 0.01)

    e, heads = cfg["embed_dim"], cfg["eva_numheads"]
    hd, regs = e // heads, cfg["num_register_tokens"]
    with no_tf32(), torch.no_grad():
        # the tokenizer
        y = norm_act(conv(x.float(), "tokenizer.stem"))
        for i, depth in enumerate(cfg["tokenizer_depth_per_level"]):
            y = norm_act(conv(y, f"tokenizer.stages.{i}.down", stride=2))
            for j in range(depth):
                k = f"tokenizer.stages.{i}.blocks.{j}"
                z = norm_act(conv(y, f"{k}.conv1"))
                y = norm_act(conv(z, f"{k}.conv2"), residual=y)
        y = conv(y, "tokenizer.proj", pad=0)
        B = y.shape[0]
        g = y.shape[2:]
        tokens = y.flatten(2).transpose(1, 2)  # (B, N, E), row-major grid
        if cfg["use_abs_pos_embed"]:
            tokens = tokens + sd["pos_embed"].float()
        if regs:
            tokens = torch.cat([sd["register_tokens"].float().expand(
                B, regs, e), tokens], dim=1)
        tokens = rnd(tokens, "residual_stream")
        turn = None
        if cfg["use_rot_pos_emb"]:
            a = rotary_angles(cfg, x.device)
            # (N, hd / 2), each pair's turn as a complex f32 number
            turn = torch.polar(torch.ones_like(a), a).to(torch.complex64)

        def rotate(t):  # (B, H, R + N, hd): turn the patch tokens' pairs
            if turn is None:
                return t
            c = torch.view_as_complex(t[:, :, regs:].reshape(
                *t.shape[:2], -1, hd // 2, 2).contiguous())
            rot = rnd(torch.view_as_real(c * turn).flatten(-2), "rope")
            return torch.cat([t[:, :, :regs], rot], dim=2)

        for i in range(cfg["eva_depth"]):
            k = f"blocks.{i}"
            h = layer_norm(tokens, f"{k}.norm1", 1e-6, e)
            q, kk, v = (linear(h, f"{k}.{n}").view(B, -1, heads, hd)
                        for n in ("q_proj", "k_proj", "v_proj"))
            if cfg["qk_norm"]:
                q = layer_norm(q, f"{k}.q_norm", 1e-5, hd)
                kk = layer_norm(kk, f"{k}.k_norm", 1e-5, hd)
            q, kk, v = (t.transpose(1, 2) for t in (q, kk, v))
            q, kk, v = (rnd(t, "attention_qkv")
                        for t in (rotate(q), rotate(kk), v))
            p = torch.softmax(q @ kk.transpose(-1, -2) / math.sqrt(hd),
                              dim=-1)
            o = p @ v
            del p
            o = o.transpose(1, 2).reshape(B, -1, e)
            if cfg["scale_attn_inner"]:
                o = layer_norm(o, f"{k}.attn_inner_norm", 1e-6, e)
            o = linear(o, f"{k}.proj")
            if cfg["init_values"] is not None:
                o = o * sd[f"{k}.gamma1"].float()
            tokens = rnd(tokens + o, "residual_stream")
            h = layer_norm(tokens, f"{k}.norm2", 1e-6, e)
            m = linear(F.silu(linear(h, f"{k}.mlp_w1", "mlp"))
                       * linear(h, f"{k}.mlp_w2", "mlp"), f"{k}.mlp_w3",
                       "mlp")
            if cfg["init_values"] is not None:
                m = m * sd[f"{k}.gamma2"].float()
            tokens = rnd(tokens + m, "residual_stream")
        tokens = layer_norm(tokens, "norm", 1e-6, e)[:, regs:]
        y = tokens.transpose(1, 2).reshape(B, e, *g)
        # the decoder: the product rounded before its bias is added, the
        # bias added in the decoder's type (the last one cancels under
        # demean)
        n_dec = len(decoder_widths(cfg))
        for i in range(n_dec):
            y = rnd(F.conv_transpose3d(
                rnd(y, "decoder"), rnd(sd[f"decoder.{i}.weight"].float(),
                                       "decoder"), stride=2), "decoder")
            y = y + rnd(sd[f"decoder.{i}.bias"].float(), "decoder")[
                :, None, None, None]
            if i < n_dec - 1:
                y = rnd(y, "decoder")
                y = rnd(F.layer_norm(y.movedim(1, -1), (y.shape[1],),
                                     eps=1e-6).movedim(-1, 1), "decoder")
                y = rnd(F.gelu(y, approximate="tanh"), "decoder")
        return rnd(y - y.mean(dim=(2, 3, 4), keepdim=True), "decoder")
