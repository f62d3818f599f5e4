"""Inference forward of the anatomix UNets on a D-shard of one volume.

The spatially sharded counterpart of `models/unet_fused.py` (the JAX
package's `unet_apply(..., spatial_axis_name=...)`, `models/unet.py:
428-455`, driven by `extract.spatial_sharded_unet`). Each rank of
a 'space' group holds an equal contiguous D-shard `(B, Dl, H, W, C)` and
the same packed weights (`unet_fused.prepack_fused`, batch norms folded):

- every conv: the halo exchange (`parallel/spatial.halo_exchange_`, into
  the halo planes of the buffer its input was written to; the global
  edges by the model's padding), then K1 in its D-valid mode
  (`kernels/conv.conv3x3x3_dvalid_ndhwc`), bias and the activation in its
  epilogue as in the unsharded walk;
- a live instance norm: each shard's f32 moments averaged over the group
  (`ops/norms.instance_norm_stats(..., group=)`; the shards are of equal
  size, as in JAX's `pmean`), applied by D1 (`kernels/norm.
  norm_apply_ndhwc`, the three-term split where the unsharded walk stores
  it); a residual block's D1 pass (its norm, activation and `+ 0.1 x`)
  as in the unsharded walk;
- the padding: reflect, replicate or zeros at the volume's two D ends and
  on H and W; circular raises `ValueError`, since a periodic D halo would
  join the first and last shards (the JAX package's spatial path has no
  circular halo either, `anatomix_tpu/models/unet.py:435-436`), and so do
  1-D and 2-D nets, which have no D axis to shard;
- pools and the nearest upsample: shard-local;
- the trilinear upsample: a one-plane halo (replicate at the global
  edges, the edge clamp of `align_corners=False`), D2
  (`kernels/resize.upsample2x_trilinear_ndhwc`), then the two outer output
  planes on each side cropped: output plane 2i + 2 of the haloed shard is
  plane 2i of the shard's own upsample, reading its neighbour's plane at
  the seam, where the JAX package clamps (ROADMAP F9);
- the decoder concat is materialized, as in JAX's `unet_apply` (once, the
  upsample written straight into its channels), so the sharded walk needs
  neither K3 nor D3.
"""

from __future__ import annotations

from typing import Any

import torch

from anatomix_tpu_torch.kernels.conv import conv3x3x3_dvalid_ndhwc
from anatomix_tpu_torch.kernels.norm import norm_apply_ndhwc
from anatomix_tpu_torch.kernels.resize import upsample2x_trilinear_ndhwc
from anatomix_tpu_torch.models.unet import UnetPlan
from anatomix_tpu_torch.ops.conv import merge3, split3
from anatomix_tpu_torch.ops.norms import (
    fold_affine,
    instance_norm_stats,
    tile_maps,
)
from anatomix_tpu_torch.ops.pool import avg_pool, max_pool
from anatomix_tpu_torch.ops.resize import upsample2x
from anatomix_tpu_torch.parallel.spatial import halo_exchange_


def _haloed(like: torch.Tensor, channels: int, dtype) -> torch.Tensor:
    """A (1, Dl + 2, H, W, channels) buffer for a tensor of `like`'s
    spatial shape (1, Dl, H, W, ...): its interior `buf[:, 1:-1]`, where a
    producer writes, is contiguous, and the halo planes are filled in place
    before a conv reads it."""
    _, dl, h, w = like.shape[:4]
    return torch.empty((1, dl + 2, h, w, channels), dtype=dtype,
                       device=like.device)


def _upsampled_into(dst: torch.Tensor, small: torch.Tensor, interp: str,
                    group, split: bool) -> None:
    """Write the 2x upsample of the shard whose haloed buffer is `small`
    into `dst` (1, 2 ds, 2 hs, 2 ws, C), one pass: nearest from an expanded
    view of the interior; trilinear through D2 on the haloed buffer, its
    halo replicate at the volume's ends (the edge clamp of
    `align_corners=False`), the two outer output planes on each side
    cropped, where the JAX package clamps at every seam (ROADMAP F9)."""
    if interp == "nearest":
        s = small[:, 1:-1]
        _, ds, hs, ws, c = s.shape
        dst.view(1, ds, 2, hs, 2, ws, 2, c).copy_(
            s[:, :, None, :, None, :, None, :].expand(
                1, ds, 2, hs, 2, ws, 2, c))
    else:
        halo_exchange_(small, group, "replicate")
        dst.copy_(upsample2x_trilinear_ndhwc(small, split=split)[:, 2:-2])


def _norm_apply_into(feat, p, cfg, group, compute_dtype, post_res=False):
    """D1 on the shard `feat` into a new haloed buffer: the batch norm's
    running affine, or the instance norm's moments averaged over the
    group; with `post_res` the residual block's `+ 0.1 feat`."""
    if "a" in p:
        a = p["a"].reshape(1, 1, 1, 1, -1).expand(
            feat.shape[0], 1, 1, 1, -1)
        s = p["s"].reshape(1, 1, 1, 1, -1).expand_as(a)
    else:
        mean, var = instance_norm_stats(feat, group=group)
        a, s = fold_affine(mean, var, cfg.norm_eps, p["scale"], p["bias"])
    c = feat.shape[-1]
    buf = _haloed(feat, 3 * c if p["split"] else c, compute_dtype)
    norm_apply_ndhwc(
        feat, a.contiguous(), s.contiguous(),
        tile_maps(feat.shape[1:4], (1, 1, 1), feat.device),
        act=p["act"], slope=p["slope"], out_dtype=compute_dtype,
        split=p["split"], out=buf[:, 1:-1], post_res=post_res)
    return buf


def unet_apply_sharded(
    plan: UnetPlan,
    packed: dict[int, dict[str, Any]],
    x: torch.Tensor,
    group,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Forward of this rank's NDHWC D-shard `x` (B, Dl, H, W, Cin) of a
    volume sharded over `group`; returns the f32 features of the shard
    (B, Dl, H, W, Co). Dl and H, W must be divisible by 2**num_downs.
    Batch items run one after the other: each activation lives in a haloed
    buffer of one item, whose interior the kernels write and whose halo
    planes the exchange fills in place, so no conv input is copied to be
    padded."""
    if x.shape[0] != 1:
        return torch.cat([unet_apply_sharded(plan, packed, x[b:b + 1], group,
                                             compute_dtype=compute_dtype)
                          for b in range(x.shape[0])])
    cfg = plan.config
    if cfg.pad_type == "circular" or cfg.dimension != 3:
        raise ValueError("the spatially sharded forward takes 3-D UNets "
                         "with reflect, replicate or zeros padding, got "
                         f"{cfg.dimension}-D {cfg.pad_type!r}")
    last_conv = plan.conv_indices[-1]
    split = packed[plan.conv_indices[0]]["split"]
    first = split3(x.float()) if split else x.to(compute_dtype)
    buf = _haloed(x, first.shape[-1], first.dtype)
    buf[:, 1:-1] = first
    enc_bufs: list[torch.Tensor] = []
    small = None  # the haloed buffer an upsample reads
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            p = packed[idx]
            out_dtype = (torch.float32 if idx == last_conv or p["f32_out"]
                         else compute_dtype)
            out = _haloed(buf[:, 1:-1], p["w"].shape[1], out_dtype)
            conv3x3x3_dvalid_ndhwc(
                halo_exchange_(buf, group, cfg.pad_type), p["w"], p["b"],
                act=p["act"], slope=p["slope"], pad_type=cfg.pad_type,
                out_dtype=out_dtype, out=out[:, 1:-1])
            buf = out
            if "block" in p:
                buf = _norm_apply_into(buf[:, 1:-1], p["block"], cfg, group,
                                       compute_dtype, post_res=True)
        elif spec.kind == "norm" and idx in packed:
            buf = _norm_apply_into(buf[:, 1:-1], packed[idx], cfg, group,
                                   compute_dtype)
        elif spec.kind == "pool":
            pool = max_pool if cfg.pooling == "Max" else avg_pool
            feat = buf[:, 1:-1]
            pooled = (split3(pool(merge3(feat), 2)) if split
                      else pool(feat, 2))
            buf = _haloed(pooled, pooled.shape[-1], pooled.dtype)
            buf[:, 1:-1] = pooled
        elif spec.kind == "upsample":
            small = buf
            buf = None
        # 'act' / 'final_act' ran in a conv epilogue or a norm-apply pass;
        # 'identity' is a folded norm
        if small is not None and buf is None:
            # the decoder conv's input: cat([enc, up(small)]), materialized
            # once, into its haloed buffer
            enc = enc_bufs.pop() if cfg.use_skip_connection else None
            c1 = enc.shape[-1] if enc is not None else 0
            dl, h, w = (2 * (small.shape[1] - 2), 2 * small.shape[2],
                        2 * small.shape[3])
            buf = torch.empty((1, dl + 2, h, w, c1 + small.shape[-1]),
                              dtype=small.dtype, device=small.device)
            if enc is not None:
                buf[:, 1:-1, ..., :c1] = enc[:, 1:-1]
            _upsampled_into(buf[:, 1:-1, ..., c1:], small, cfg.interp,
                            group, split)
            small = None
        if cfg.use_skip_connection and idx in plan.encoder_idx:
            enc_bufs.append(buf)
    return buf[:, 1:-1]
