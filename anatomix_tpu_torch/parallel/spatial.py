"""Spatial sharding of one volume over a 'space' group, with halo exchange.

The port of `anatomix_tpu/parallel/spatial.py`: the volume's D axis is cut
into equal contiguous shards, one per rank of the group; before every conv
each shard trades one D-plane with each neighbour (`halo_exchange_`, point
to point with `dist.batch_isend_irecv`, into the halo planes of the
buffer the shard was written to; the global edges follow the padding:
reflect, replicate or zeros), and the conv runs valid along D on the
haloed shard (K1's D-valid mode). Instance-norm statistics are averaged
over the group; pools and the nearest upsample stay shard-local; the
shards' features are gathered along D (`gather_d`). The walk is
`models/unet_sharded.py`, its entry point `extract.spatial_sharded_unet`.

The JAX package also keeps its trilinear upsample shard-local
(`models/unet.py:509-525`), so each shard's edge planes clamp at the seam
instead of reading the neighbour's plane, and its sharded forward of a
trilinear UNet is not the unsharded one (ROADMAP F9). The port's walk gives
the upsample a one-plane halo (replicate at the global edges) and crops
the two outer output planes, so its sharded forward is the unsharded one
for every UNet it supports.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_EDGE_PAD = ("reflect", "replicate", "zeros")


def halo_exchange_(buf: torch.Tensor, group, pad_type: str = "reflect"):
    """Fill the halo planes 0 and Dl + 1 of this rank's haloed shard `buf`
    (B, Dl + 2, H, W, C), whose interior planes 1..Dl hold the shard, in
    place: from the neighbours' edge planes, and at the volume's two ends
    with the plane `pad_type` gives (reflect: interior plane 2 / Dl - 1;
    replicate: the edge plane; zeros). Returns `buf`."""
    if pad_type not in _EDGE_PAD:
        raise ValueError(f"unsupported pad_type {pad_type!r}")
    n = dist.get_world_size(group)
    idx = dist.get_group_rank(group, dist.get_rank())
    dl = buf.shape[1] - 2
    if dl < (2 if pad_type == "reflect" else 1):
        raise ValueError(f"{pad_type} halos need at least "
                         f"{2 if pad_type == 'reflect' else 1} planes per "
                         f"shard, got {dl}")
    # a plane of a batch of one is contiguous: send and receive in place
    plane = (lambda i: buf[:, i]) if buf.shape[0] == 1 else (
        lambda i: buf[:, i].contiguous())
    ops, recv = [], []
    if idx > 0:
        peer = dist.get_global_rank(group, idx - 1)
        into = plane(0)
        ops += [dist.P2POp(dist.isend, plane(1), peer, group),
                dist.P2POp(dist.irecv, into, peer, group)]
        recv.append((0, into))
    if idx < n - 1:
        peer = dist.get_global_rank(group, idx + 1)
        into = plane(dl + 1)
        ops += [dist.P2POp(dist.isend, plane(dl), peer, group),
                dist.P2POp(dist.irecv, into, peer, group)]
        recv.append((dl + 1, into))
    if ops:  # a group of one holds the whole volume: its edges alone
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for i, into in recv:
            if into.data_ptr() != buf[:, i].data_ptr():
                buf[:, i] = into
    edges = []
    if idx == 0:
        edges.append((0, 2 if pad_type == "reflect" else 1))
    if idx == n - 1:
        edges.append((dl + 1, dl - 1 if pad_type == "reflect" else dl))
    for dst, src in edges:
        if pad_type == "zeros":
            buf[:, dst] = 0
        else:
            buf[:, dst] = buf[:, src]
    return buf


def halo_pad_d(x: torch.Tensor, group, pad_type: str = "reflect"):
    """Pad the sharded D axis of this rank's shard `x` (B, Dl, H, W, C) by
    one plane on each side (`halo_exchange_`); returns the new
    (B, Dl + 2, H, W, C)."""
    B, dl = x.shape[:2]
    buf = x.new_empty((B, dl + 2) + tuple(x.shape[2:]))
    buf[:, 1:-1] = x
    return halo_exchange_(buf, group, pad_type)


def gather_d(y: torch.Tensor, group) -> torch.Tensor:
    """The whole volume from every rank's D-shard `y` (B, Dl, H, W, C), the
    shards in group-rank order along D, on every rank."""
    n = dist.get_world_size(group)
    out = y.new_empty((n * y.shape[0],) + tuple(y.shape[1:]))
    dist.all_gather_into_tensor(out, y.contiguous(), group=group)
    # for a batch of one the ranks' blocks of `out` are the D-shards
    return out.view((n,) + tuple(y.shape)).transpose(0, 1).reshape(
        (y.shape[0], n * y.shape[1]) + tuple(y.shape[2:]))


def receptive_field(plan) -> int:
    """Full-resolution receptive field of the UNet (for slab-halo
    sizing)."""
    rf, stride = 1, 1
    for spec in plan.layers:
        if spec.kind == "conv":
            rf += 2 * stride
        elif spec.kind == "pool":
            rf += stride  # window 2
            stride *= 2
        elif spec.kind == "upsample":
            stride = max(stride // 2, 1)
    return rf
