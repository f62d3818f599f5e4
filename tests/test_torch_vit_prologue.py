"""The ViT's attention prologue (`kernels/attention.qkv_prologue`: the
per-head q/k LayerNorm, the interleaved RoPE and the bf16 (B, H, N, hd) pack
of q, k and v) on the CPU, where the wrapper runs its plain version.

The plain route against a float64 numpy LayerNorm and rotation; the layout,
dtype and single rounding of what it hands V3; the register tokens left
unrotated; the wrapper's input checks; and `Primus.forward` on the plain and
the default route against the composition the model ran before the
prologue had its kernel (a frozen copy of that `_attention`). The kernel
itself is held to its plain version on the card (`tests/test_torch_gpu.py`).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from anatomix_tpu_torch.kernels.attention import (
    _check_prologue,
    qkv_prologue,
)
from anatomix_tpu_torch.models.vit3d import (
    Primus,
    PrimusConfig,
    init_primus_params,
)
from anatomix_tpu_torch.models.vit3d.primus import _apply_rope

B, H, N_PATCH = 2, 2, 12

SRC = (Path(__file__).resolve().parents[1] / "anatomix_tpu_torch" / "kernels"
       / "csrc" / "flash_attention.cu").read_text()


def _inputs(hd, R, seed=0):
    """q, k, v (B, R + N_PATCH, H hd) f32 with a per-head offset, as a
    projection with biases gives; LayerNorm affines near (1, 0); tables of
    random angles (N_PATCH, hd / 2)."""
    rng = np.random.default_rng(seed)
    N, D = R + N_PATCH, H * hd
    qkv = [(rng.standard_normal((B, N, D)) * 1.5
            + rng.standard_normal(D) * 0.5).astype(np.float32)
           for _ in range(3)]
    # q weight, q bias, k weight, k bias
    norms = [(w + s * rng.standard_normal(hd)).astype(np.float32)
             for w, s in ((1, 0.1), (0, 0.05), (1, 0.1), (0, 0.05))]
    angles = rng.uniform(-math.pi, math.pi, (N_PATCH, hd // 2))
    tables = [np.cos(angles).astype(np.float32),
              np.sin(angles).astype(np.float32)]
    return qkv, norms, tables


def _reference(x, norm, tables, R, eps=1e-5):
    """float64: LayerNorm over hd (biased variance), then the rotation of
    the pairs (2i, 2i + 1) of every token after the first R; (B, H, N, hd)."""
    x = x.astype(np.float64).reshape(B, -1, H, x.shape[-1] // H)
    if norm is not None:
        mean = x.mean(-1, keepdims=True)
        var = ((x - mean) ** 2).mean(-1, keepdims=True)
        x = (x - mean) / np.sqrt(var + eps) * norm[0] + norm[1]
    x = x.transpose(0, 2, 1, 3).copy()
    if tables is not None:
        c, s = (t.astype(np.float64) for t in tables)
        x0, x1 = x[:, :, R:, 0::2].copy(), x[:, :, R:, 1::2].copy()
        x[:, :, R:, 0::2] = x0 * c - x1 * s
        x[:, :, R:, 1::2] = x0 * s + x1 * c
    return x


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("qk_norm", [True, False])
@pytest.mark.parametrize("R", [0, 8])
@pytest.mark.parametrize("hd", [66, 72])
def test_prologue_plain_route_matches_float64(hd, R, qk_norm, rope):
    """f32 before the rounding within 1e-6 of a float64 LayerNorm and
    rotation (max |err| / max |ref|, v exact); the default store is the
    contiguous bf16 (B, H, N, hd) that `flash_attention` takes, rounded
    once from those f32 values; the registers are not rotated."""
    qkv, norms, tables = _inputs(hd, R)
    t = [torch.from_numpy(a) for a in qkv]
    kw = dict(registers=R)
    if qk_norm:
        kw.update(q_norm=tuple(torch.from_numpy(a) for a in norms[:2]),
                  k_norm=tuple(torch.from_numpy(a) for a in norms[2:]))
    if rope:
        kw["rope"] = tuple(torch.from_numpy(a) for a in tables)
    f32 = qkv_prologue(*t, H, out_dtype=torch.float32, **kw)
    refs = [_reference(qkv[i], (norms[2 * i], norms[2 * i + 1])
                       if qk_norm and i < 2 else None,
                       tables if rope and i < 2 else None, R)
            for i in range(3)]
    for got, ref in zip(f32, refs):
        assert got.shape == (B, H, R + N_PATCH, hd)
        err = np.abs(got.numpy().astype(np.float64) - ref).max()
        assert err <= 1e-6 * np.abs(ref).max()
    assert np.array_equal(f32[2].numpy(), refs[2].astype(np.float32))

    packed = qkv_prologue(*t, H, **kw)
    for got, want in zip(packed, f32):
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.shape == (B, H, R + N_PATCH, hd)
        assert torch.equal(got, want.to(torch.bfloat16))
    if rope:
        unrotated = qkv_prologue(*t, H, **dict(kw, rope=None))
        for i, (got, plain) in enumerate(zip(packed, unrotated)):
            assert torch.equal(got[:, :, :R], plain[:, :, :R])
            # q and k turn after the registers, v never
            assert torch.equal(got[:, :, R:], plain[:, :, R:]) == (i == 2)


@pytest.mark.parametrize("fault", ["odd_hd", "heads", "registers",
                                   "one_norm", "table_shape", "f16_out"])
def test_prologue_checks_its_inputs(fault):
    """What the kernel does not take is refused before a launch."""
    qkv, norms, tables = _inputs(66, 8)
    t = [torch.from_numpy(a) for a in qkv]
    heads, R, out = H, 8, torch.bfloat16
    q_norm = tuple(torch.from_numpy(a) for a in norms[:2])
    k_norm = tuple(torch.from_numpy(a) for a in norms[2:])
    rope = tuple(torch.from_numpy(a) for a in tables)
    if fault == "odd_hd":
        t = [x[..., :-2].contiguous() for x in t]  # D 130: hd 65
        q_norm = k_norm = rope = None
    elif fault == "heads":
        heads = 5
    elif fault == "registers":
        R = R + N_PATCH + 1
        rope = None
    elif fault == "one_norm":
        k_norm = None
    elif fault == "table_shape":
        rope = tuple(x[1:].contiguous() for x in rope)
    else:
        out = torch.float16
    with pytest.raises(ValueError):
        _check_prologue(*t, heads, q_norm, k_norm, rope, R, out)


def test_prologue_check_takes_the_vit_shapes():
    """The ViT's own operands pass the checks (hd 66 with R 8 and both
    options, and hd 72 bare)."""
    for hd, R, full in ((66, 8, True), (72, 0, False)):
        qkv, norms, tables = _inputs(hd, R)
        t = [torch.from_numpy(a) for a in qkv]
        args = ((tuple(torch.from_numpy(a) for a in norms[:2]),
                 tuple(torch.from_numpy(a) for a in norms[2:]),
                 tuple(torch.from_numpy(a) for a in tables)) if full
                else (None, None, None))
        _check_prologue(*t, H, *args, R, torch.bfloat16)


@pytest.mark.parametrize("b,n,h", [(2, 4104, 6), (1, 77, 2), (3, 5, 7),
                                   (1, 9, 1)])
def test_prologue_kernel_walk_stores_every_row_once(b, n, h):
    """`qkv_prologue_kernel`'s walk, replayed: warp w of block x owns rows
    (x warps + w) PRO_RW + j of the (B, N, H) row order, decodes the first
    by division and steps the head for the next; every row lands once, in
    its own (sample, head, token) slot of the (B, H, N, hd) store."""
    consts = {k: int(re.search(rf"constexpr int {k} = (\d+);", SRC).group(1))
              for k in ("PRO_THREADS", "PRO_RW")}
    warps, rw = consts["PRO_THREADS"] // 32, consts["PRO_RW"]
    rows = b * n * h
    blocks = -(-rows // (warps * rw))
    seen = np.zeros((b, h, n), np.int64)
    for wid in range(blocks * warps):
        row0 = wid * rw
        hh, nn, bi = row0 % h, row0 // h % n, row0 // h // n
        for j in range(rw):
            if row0 + j >= rows:
                break
            if j > 0:
                hh += 1
                if hh == h:
                    hh, nn = 0, nn + 1
                    if nn == n:
                        nn, bi = 0, bi + 1
            assert (bi, nn, hh) == np.unravel_index(row0 + j, (b, n, h))
            seen[bi, hh, nn] += 1
    assert (seen == 1).all()


def _parent_attention(self, blk, h, ops, cd):
    """`Primus._attention` as it composed the prologue in torch before
    `qkv_prologue` (frozen here)."""
    cfg = self.cfg
    B, N, D = h.shape
    H, hd, R = cfg.eva_numheads, cfg.head_dim, cfg.num_register_tokens
    q = blk.q_proj(h).view(B, N, H, hd)
    k = blk.k_proj(h).view(B, N, H, hd)
    v = blk.v_proj(h).view(B, N, H, hd)
    if cfg.qk_norm:
        q, k = blk.q_norm(q), blk.k_norm(k)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, N, hd)
    if cfg.use_rot_pos_emb:
        cos, sin = self.rope_cos, self.rope_sin
        q = torch.cat([q[:, :, :R], _apply_rope(q[:, :, R:], cos, sin)],
                      dim=2)
        k = torch.cat([k[:, :, :R], _apply_rope(k[:, :, R:], cos, sin)],
                      dim=2)
    o = ops.attn(*(t.to(cd).contiguous() for t in (q, k, v)),
                 1.0 / math.sqrt(hd))
    o = o.transpose(1, 2).reshape(B, N, D).float()
    if cfg.scale_attn_inner:
        o = blk.attn_inner_norm(o)
    return blk.proj(o)


@pytest.mark.parametrize("plain", [True, False])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("options", ["registers_qk_norm_rope", "bare"])
def test_forward_equals_the_parent_composition(plain, compute_dtype,
                                               options, monkeypatch):
    """`Primus.forward` (plain route and CPU default) gives the same bits
    as with the frozen torch composition, and so does every block's
    residual stream that the `record` hook sees."""
    kw = (dict(num_register_tokens=2, qk_norm=True, use_rot_pos_emb=True)
          if options != "bare" else
          dict(num_register_tokens=0, qk_norm=False, use_rot_pos_emb=False))
    cfg = PrimusConfig(embed_dim=24, eva_depth=2, eva_numheads=2,
                       input_shape=(16, 16, 16), num_classes=8,
                       tokenizer_base_features=4, scale_attn_inner=True,
                       out_norm="demean", **kw)
    model = Primus.from_state_dict(
        cfg, init_primus_params(cfg, torch.Generator().manual_seed(0)),
        device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 16, 16, 16, 1)).astype(np.float32))

    def run():
        seen = {}
        y = model(x, compute_dtype=compute_dtype, plain=plain,
                  record=lambda name, t: seen.setdefault(name, t.clone()))
        return y, seen

    got, got_seen = run()
    monkeypatch.setattr(Primus, "_attention", _parent_attention)
    want, want_seen = run()
    assert torch.equal(got, want)
    assert got_seen.keys() == want_seen.keys()
    for name in want_seen:
        assert torch.equal(got_seen[name], want_seen[name]), name
