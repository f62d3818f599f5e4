"""Weights of the Primus ViT: the JAX pytree, its `.npz`, and the upstream
`.pth`, into the port's state dict.

The port's state dict is `Primus.state_dict()`: the JAX pytree's paths as
module keys, in torch layouts (convs (O, I, kD, kH, kW), linears (out, in),
the decoder's transposed convs (I, O, 2, 2, 2), LayerNorm `scale`/`bias` as
`weight`/`bias`). `from_jax_primus_params` maps a pytree with numpy leaves
into it; `load_pytree_npz` reads the JAX package's `save_pytree` `.npz`
without JAX; `convert_primus_state_dict` is the port's own copy of the JAX
package's best-effort converter of the upstream `.pth` layout (timm-EVA
names under `eva.`, convs matched by shape in natural key order), which
returns the pytree. `load_primus_state_dict` reads either file.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from anatomix_tpu_torch.models.convert import strip_prefixes
from anatomix_tpu_torch.models.vit3d.primus import (
    PrimusConfig,
    _decoder_widths,
    _tokenizer_widths,
)


def _t(val) -> torch.Tensor:
    return torch.from_numpy(np.array(val, dtype=np.float32))


def from_jax_primus_params(cfg: PrimusConfig, params: Mapping[str, Any]):
    """JAX Primus pytree (numpy or JAX leaves) -> the port's state dict
    (CPU f32). A conv without a bias gets a zero one."""
    sd: dict[str, torch.Tensor] = {}

    def conv(key, p, perm=(4, 3, 0, 1, 2)):
        w = np.asarray(p["w"], np.float32)
        sd[f"{key}.weight"] = _t(np.transpose(w, perm))
        b = p.get("b")
        sd[f"{key}.bias"] = _t(np.zeros(w.shape[-1]) if b is None else b)

    def ln(key, p):
        if p["scale"] is None or p["bias"] is None:
            raise ValueError(f"{key}: the LayerNorm's scale or bias is "
                             "missing")
        sd[f"{key}.weight"] = _t(p["scale"])
        sd[f"{key}.bias"] = _t(p["bias"])

    def linear(key, p):
        sd[f"{key}.weight"] = _t(np.asarray(p["w"], np.float32).T)
        if "b" in p:
            sd[f"{key}.bias"] = _t(p["b"])

    tok = params["tokenizer"]
    if cfg.version == "v1":
        conv("tokenizer.proj", tok["proj"])
        ln("tokenizer.norm", tok["norm"])
    else:
        conv("tokenizer.stem", tok["stem"])
        for i, st in enumerate(tok["stages"]):
            conv(f"tokenizer.stages.{i}.down", st["down"])
            for j, blk in enumerate(st["blocks"]):
                for name in ("conv1", "conv2"):
                    conv(f"tokenizer.stages.{i}.blocks.{j}.{name}",
                         blk[name])
        conv("tokenizer.proj", tok["proj"])
    if "pos_embed" in params:
        sd["pos_embed"] = _t(params["pos_embed"])
    if "register_tokens" in params:
        sd["register_tokens"] = _t(params["register_tokens"])
    for i, blk in enumerate(params["blocks"]):
        base = f"blocks.{i}"
        for name in ("norm1", "norm2", "q_norm", "k_norm",
                     "attn_inner_norm"):
            if name in blk:
                ln(f"{base}.{name}", blk[name])
        for name in ("q_proj", "k_proj", "v_proj", "proj", "mlp_w1",
                     "mlp_w2", "mlp_w3"):
            linear(f"{base}.{name}", blk[name])
        for name in ("gamma1", "gamma2"):
            if name in blk:
                sd[f"{base}.{name}"] = _t(blk[name])
    ln("norm", params["norm"])
    for i, p in enumerate(params["decoder"]):
        # DHWIO (2, 2, 2, I, O) scatter layout -> ConvTranspose3d (I, O, ...)
        conv(f"decoder.{i}", p, perm=(3, 4, 0, 1, 2))
    return sd


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    """The JAX package's `utils/checkpoint._unflatten`: '/'-joined paths,
    lists as '[i]' with a `__len__` entry, None as `__none__`."""
    if list(flat.keys()) == [""]:
        return flat[""]
    groups: dict[str, dict] = {}
    scalars: dict[str, np.ndarray] = {}
    for key, val in flat.items():
        if "/" in key:
            head, rest = key.split("/", 1)
            groups.setdefault(head, {})[rest] = val
        else:
            scalars[key] = val
    if "__len__" in scalars or any(k.startswith("[") for k in groups):
        meta = scalars.get("__len__")
        n = int(meta[0]) if meta is not None else len(groups)
        as_tuple = bool(meta[1]) if meta is not None else False
        items = [_unflatten(groups[f"[{i}]"]) for i in range(n)]
        return tuple(items) if as_tuple else items
    if "__none__" in scalars:
        return None
    out: dict[str, Any] = dict(scalars)
    for k, sub in groups.items():
        out[k] = _unflatten(sub)
    return out


def load_pytree_npz(path: str) -> Any:
    """Read a pytree written by the JAX package's `save_pytree`."""
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def _t_np(w):  # torch Linear weight (out, in) -> (in, out)
    return np.ascontiguousarray(np.transpose(np.asarray(w), (1, 0)))


def _conv_t(w):  # torch Conv3d (O, I, kD, kH, kW) -> DHWIO
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 4, 1, 0)))


def _deconv_t(w):  # torch ConvTranspose3d (I, O, kD, kH, kW) -> DHWIO
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 4, 0, 1)))


def _natkey(k):
    # numeric module indices compare as integers ("encoder.10" after
    # "encoder.2"), so same-shape convs keep their forward order
    return [(0, int(t)) if t.isdigit() else (1, t)
            for t in re.split(r"(\d+)", k)]


def convert_primus_state_dict(
    cfg: PrimusConfig, state_dict: Mapping[str, Any]
) -> tuple[dict[str, Any], list[str], list[str]]:
    """Upstream `.pth` state dict -> (JAX-layout pytree with numpy leaves,
    unmapped source keys, unfilled targets); the same key map as the JAX
    package's `models/vit3d/convert.convert_primus_state_dict`."""
    sd = {
        k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                      else v)
        for k, v in strip_prefixes(state_dict).items()
    }
    used: set[str] = set()
    unfilled: list[str] = []

    def take(*names, transform=None, optional=False):
        for name in names:
            if name in sd:
                used.add(name)
                val = sd[name]
                return (transform(val) if transform
                        else val.astype(np.float32))
        if not optional:
            unfilled.append(names[0])
        return None

    params: dict[str, Any] = {}
    pos = take("eva.pos_embed", "pos_embed", optional=True)
    if pos is not None:
        params["pos_embed"] = pos.reshape(-1, cfg.embed_dim)
    regs = take("register_tokens", "eva.register_tokens", optional=True)
    if regs is not None:
        params["register_tokens"] = regs.reshape(-1, cfg.embed_dim)

    blocks = []
    for i in range(cfg.eva_depth):
        base = f"eva.blocks.{i}"
        blk: dict[str, Any] = {
            "norm1": {"scale": take(f"{base}.norm1.weight"),
                      "bias": take(f"{base}.norm1.bias")},
            "q_proj": {"w": take(f"{base}.attn.q_proj.weight",
                                 transform=_t_np),
                       "b": take(f"{base}.attn.q_bias",
                                 f"{base}.attn.q_proj.bias")},
            "k_proj": {"w": take(f"{base}.attn.k_proj.weight",
                                 transform=_t_np)},
            "v_proj": {"w": take(f"{base}.attn.v_proj.weight",
                                 transform=_t_np),
                       "b": take(f"{base}.attn.v_bias",
                                 f"{base}.attn.v_proj.bias")},
            "proj": {"w": take(f"{base}.attn.proj.weight", transform=_t_np),
                     "b": take(f"{base}.attn.proj.bias")},
        }
        if cfg.qk_norm:
            for name in ("q_norm", "k_norm"):
                blk[name] = {"scale": take(f"{base}.attn.{name}.weight"),
                             "bias": take(f"{base}.attn.{name}.bias")}
        if cfg.scale_attn_inner:
            blk["attn_inner_norm"] = {
                "scale": take(f"{base}.attn.norm.weight"),
                "bias": take(f"{base}.attn.norm.bias")}
        if cfg.init_values is not None:
            blk["gamma1"] = take(f"{base}.gamma_1", f"{base}.ls1.gamma")
            blk["gamma2"] = take(f"{base}.gamma_2", f"{base}.ls2.gamma")
        blk["norm2"] = {"scale": take(f"{base}.norm2.weight"),
                        "bias": take(f"{base}.norm2.bias")}
        for name, w_alt, suffix in (("mlp_w1", "w1", "fc1_g"),
                                    ("mlp_w2", "w2", "fc1_x"),
                                    ("mlp_w3", "w3", "fc2")):
            blk[name] = {
                "w": take(f"{base}.mlp.{w_alt}.weight",
                          f"{base}.mlp.{suffix}.weight", transform=_t_np),
                "b": take(f"{base}.mlp.{w_alt}.bias",
                          f"{base}.mlp.{suffix}.bias"),
            }
        blocks.append(blk)
    params["blocks"] = blocks
    params["norm"] = {"scale": take("eva.norm.weight", "eva.fc_norm.weight"),
                      "bias": take("eva.norm.bias", "eva.fc_norm.bias")}

    def grab_convs(prefix, transform):
        items = []
        for k in sorted(sd, key=_natkey):
            if k.startswith(prefix) and k.endswith("weight") \
                    and sd[k].ndim == 5:
                bk = k[: -len("weight")] + "bias"
                items.append((k, transform(sd[k]).astype(np.float32),
                              sd[bk].astype(np.float32) if bk in sd
                              else None, bk))
        return items

    def pop_match(items, shape, what):
        for idx, (k, w, b, bk) in enumerate(items):
            if w.shape == shape:
                items.pop(idx)
                used.add(k)
                p = {"w": w}
                if b is not None:
                    used.add(bk)
                    p["b"] = b
                return p
        unfilled.append(f"{what} {shape}")
        return {"w": np.zeros(shape, np.float32)}

    tok_items = grab_convs("down_projection.", _conv_t)
    if cfg.version == "v1":
        # the single stride-p patch-embed conv and the token LayerNorm
        p = cfg.patch_embed_size
        params["tokenizer"] = {
            "proj": pop_match(
                tok_items, (p[0], p[1], p[2], cfg.input_channels,
                            cfg.embed_dim), "patch embed proj"),
            "norm": {"scale": take("down_projection.norm.weight",
                                   optional=True),
                     "bias": take("down_projection.norm.bias",
                                  optional=True)},
        }
    else:
        base = cfg.tokenizer_base_features
        stage_widths, ch = _tokenizer_widths(cfg)
        tok: dict[str, Any] = {"stem": pop_match(
            tok_items, (3, 3, 3, cfg.input_channels, base),
            "tokenizer stem")}
        stages = []
        for level, ((ci, co), depth) in enumerate(
                zip(stage_widths, cfg.tokenizer_depth_per_level)):
            stages.append({
                "down": pop_match(tok_items, (3, 3, 3, ci, co),
                                  f"tokenizer stage{level} down"),
                "blocks": [
                    {name: pop_match(
                        tok_items, (3, 3, 3, co, co),
                        f"tokenizer stage{level} block{j} {name}")
                     for name in ("conv1", "conv2")}
                    for j in range(depth)
                ],
            })
        tok["stages"] = stages
        tok["proj"] = pop_match(tok_items, (1, 1, 1, ch, cfg.embed_dim),
                                "tokenizer proj")
        params["tokenizer"] = tok

    dec_items = grab_convs("up_projection.", _deconv_t)
    params["decoder"] = [
        pop_match(dec_items, (2, 2, 2, ci, co), f"decoder up{i}")
        for i, (ci, co) in enumerate(_decoder_widths(cfg))
    ]
    unmapped = sorted(set(sd) - used)
    return params, unmapped, unfilled


def load_primus_state_dict(cfg: PrimusConfig, path: str):
    """The port's state dict (CPU f32) from a JAX `.npz` pytree or an
    upstream `.pth`; a `.pth` with unmapped or missing keys raises."""
    if path.endswith(".npz"):
        return from_jax_primus_params(cfg, load_pytree_npz(path))
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, Mapping):
        raise ValueError(f"{path} does not hold a state dict")
    params, unmapped, unfilled = convert_primus_state_dict(cfg, raw)
    if unmapped or unfilled:
        raise ValueError(
            f"{path} does not match the Primus layout: unmapped "
            f"{unmapped[:8]}, unfilled {unfilled[:8]}")
    return from_jax_primus_params(cfg, params)


def to_jax_primus_params(cfg: PrimusConfig,
                         sd: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The port's state dict -> the JAX Primus pytree (numpy leaves), the
    inverse of `from_jax_primus_params`: convs DHWIO with their bias,
    linears (in, out) (`k_proj` without a bias, as JAX builds it),
    LayerNorms `scale` / `bias`, the decoder's transposed convs DHWIO."""
    def arr(key):
        return sd[key].detach().cpu().float().numpy()

    def conv(key, perm=(2, 3, 4, 1, 0)):
        return {"w": np.ascontiguousarray(np.transpose(arr(f"{key}.weight"),
                                                       perm)),
                "b": arr(f"{key}.bias")}

    def ln(key):
        return {"scale": arr(f"{key}.weight"), "bias": arr(f"{key}.bias")}

    def linear(key):
        p = {"w": np.ascontiguousarray(arr(f"{key}.weight").T)}
        if f"{key}.bias" in sd:
            p["b"] = arr(f"{key}.bias")
        return p

    params: dict[str, Any] = {}
    if cfg.version == "v1":
        params["tokenizer"] = {"proj": conv("tokenizer.proj"),
                               "norm": ln("tokenizer.norm")}
    else:
        stages = []
        for i in range(len(cfg.tokenizer_depth_per_level)):
            base = f"tokenizer.stages.{i}"
            stages.append({"down": conv(f"{base}.down"), "blocks": [
                {name: conv(f"{base}.blocks.{j}.{name}")
                 for name in ("conv1", "conv2")}
                for j in range(cfg.tokenizer_depth_per_level[i])]})
        params["tokenizer"] = {"stem": conv("tokenizer.stem"),
                               "stages": stages,
                               "proj": conv("tokenizer.proj")}
    for name in ("pos_embed", "register_tokens"):
        if name in sd:
            params[name] = arr(name)
    blocks = []
    for i in range(cfg.eva_depth):
        base = f"blocks.{i}"
        blk = {}
        for name in ("norm1", "norm2", "q_norm", "k_norm",
                     "attn_inner_norm"):
            if f"{base}.{name}.weight" in sd:
                blk[name] = ln(f"{base}.{name}")
        for name in ("q_proj", "k_proj", "v_proj", "proj", "mlp_w1",
                     "mlp_w2", "mlp_w3"):
            blk[name] = linear(f"{base}.{name}")
        for name in ("gamma1", "gamma2"):
            if f"{base}.{name}" in sd:
                blk[name] = arr(f"{base}.{name}")
        blocks.append(blk)
    params["blocks"] = blocks
    params["norm"] = ln("norm")
    n_dec = sum(1 for k in sd if k.startswith("decoder.")
                and k.endswith(".weight"))
    params["decoder"] = [conv(f"decoder.{i}", perm=(2, 3, 4, 0, 1))
                         for i in range(n_dec)]
    return params
