"""Instance normalization on NDHWC volumes, global or per spatial tile, the
ViT's channel norms (`channel_layer_norm`, `channel_demean`) and the
pretraining step's train-mode batch norm (`batch_norm_train`).

The port of `anatomix_tpu/ops/norms.py:26-179` (the reference's
`InstanceNorm3d`: per-sample, per-channel spatial statistics, biased
variance, no running stats; `instance_affine` adds a learned scale and
bias). Statistics are f32 one-pass moments, `var = max(E[x^2] - E[x]^2, 0)`,
whatever the input dtype.

Per-tile statistics are the model of the `full_tiled` extraction strategy:
each axis is split into `tile_counts[i]` contiguous chunks by
`_even_chunk_sizes`, and each voxel is normalized with the statistics of
its own tile. Statistics never pool over the batch: in `sliding`, the
windows of one chunk are normalized each on its own.

These are the plain versions. On the card, the fused forward computes the
statistics here (`instance_norm_stats`, torch reductions) and applies them
with the `norm_apply_ndhwc` kernel (`kernels/norm.py`).
"""

from __future__ import annotations

import functools

import torch

from anatomix_tpu_torch.parallel.mesh import group_mean, group_size


def _even_chunk_sizes(size: int, n: int) -> list[int]:
    """Split `size` into `n` contiguous chunks as evenly as possible,
    with the invariant `_even_chunk_sizes(2*s, n) == 2*_even_chunk_sizes(s, n)`
    whenever `s >= n` (recursing while the size stays even and splittable).

    The invariant makes tile boundaries agree at every UNet depth: plain
    division splits 88 into [30, 29, 29] but 44 into [15, 15, 14], whose
    doubles differ. Each level computes its own sizes from its own extent.
    """
    if size < n:
        raise ValueError(
            f"cannot split size {size} into {n} non-empty tiles "
            "(tile_counts too large for this level's spatial dims)"
        )
    if size % 2 == 0 and size // 2 >= n:
        return [2 * c for c in _even_chunk_sizes(size // 2, n)]
    base, rem = divmod(size, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def tile_sizes(spatial, tile_counts) -> list[list[int]]:
    """Chunk sizes of each spatial axis for `tile_counts`."""
    return [_even_chunk_sizes(int(s), int(n))
            for s, n in zip(spatial, tile_counts)]


@functools.lru_cache(maxsize=256)
def _tile_map(size: int, n: int, device: torch.device) -> torch.Tensor:
    idx = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32),
        torch.tensor(_even_chunk_sizes(size, n)))
    return idx.to(device)


def tile_maps(spatial, tile_counts, device) -> tuple[torch.Tensor, ...]:
    """Per-axis int32 maps `voxel index -> tile index` (lengths D, H, W).
    Cached per extent and device, so a forward makes no host copies."""
    return tuple(_tile_map(int(s), int(n), torch.device(device))
                 for s, n in zip(spatial, tile_counts))


@functools.lru_cache(maxsize=64)
def _tile_counts_tensor(sizes: tuple, device: torch.device) -> torch.Tensor:
    d, h, w = (torch.tensor(s, dtype=torch.float32) for s in sizes)
    counts = d[:, None, None] * h[None, :, None] * w[None, None, :]
    return counts[None, ..., None].to(device)


def _tile_sums(x: torch.Tensor, sizes: list[list[int]]) -> torch.Tensor:
    """Sum (B, D, H, W, C) over contiguous chunks of each spatial axis:
    (B, t0, t1, t2, C)."""
    for ax in (3, 2, 1):
        sz = sizes[ax - 1]
        if len(set(sz)) == 1:
            shape = list(x.shape)
            shape[ax:ax + 1] = [len(sz), sz[0]]
            x = x.reshape(shape).sum(dim=ax + 1)
        else:
            x = torch.cat([c.sum(dim=ax, keepdim=True)
                           for c in x.split(sz, dim=ax)], dim=ax)
    return x


def instance_norm_stats(x: torch.Tensor, tile_counts=(1, 1, 1), *,
                        group=None):
    """f32 `(mean, var)` of NDHWC `x` per (sample, tile, channel), each
    (B, t0, t1, t2, C). Reduces over space only, never over the batch.
    With a process `group`, `x` is this rank's shard of a volume whose
    equal shards the group's ranks hold: the moments are averaged over the
    group (JAX's `pmean` over the 'space' axis, `anatomix_tpu/ops/
    norms.py:46-51`), one tile only."""
    sizes = tile_sizes(x.shape[1:4], tile_counts)
    x32 = x.float()
    s1 = _tile_sums(x32, sizes)
    s2 = _tile_sums(x32.square(), sizes)
    if all(len(set(s)) == 1 for s in sizes):
        counts = float(sizes[0][0] * sizes[1][0] * sizes[2][0])
    else:
        counts = _tile_counts_tensor(tuple(map(tuple, sizes)), x.device)
    mean = s1 / counts
    m2 = s2 / counts
    if group is not None:
        if tuple(tile_counts) != (1, 1, 1):
            raise ValueError("sharded statistics take one tile")
        mean, m2 = group_mean(torch.stack([mean, m2]), group)
    var = torch.clamp(m2 - mean.square(), min=0.0)
    return mean, var


def fold_affine(mean, var, eps, scale=None, bias=None):
    """Per-(tile, channel) f32 `(a, s)` with `x * a + s ==
    (x - mean) * rsqrt(var + eps) * scale + bias` (the JAX package's
    `models/unet_fused._fold_affine`)."""
    a = torch.rsqrt(var + eps)
    if scale is not None:
        a = a * scale.float()
    s = -mean * a
    if bias is not None:
        s = s + bias.float()
    return a, s


def expand_tiles(t: torch.Tensor, maps) -> torch.Tensor:
    """Per-tile (B, t0, t1, t2, C) values broadcast to per-voxel
    (B, D, H, W, C) through the per-axis `tile_maps`."""
    for ax, m in zip((1, 2, 3), maps):
        t = t.index_select(ax, m)
    return t


def tiled_instance_norm(
    x: torch.Tensor,
    tile_counts=(1, 1, 1),
    *,
    eps: float = 1e-5,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Instance norm of NDHWC `x` with statistics per spatial tile, even
    and uneven tiles alike; `tile_counts=(1, 1, 1)` is `instance_norm`."""
    mean, var = instance_norm_stats(x, tile_counts)
    inv = torch.rsqrt(var + eps)
    if tuple(tile_counts) != (1, 1, 1):
        maps = tile_maps(x.shape[1:4], tile_counts, x.device)
        mean = expand_tiles(mean, maps)
        inv = expand_tiles(inv, maps)
    y = (x.float() - mean) * inv
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def instance_norm(
    x: torch.Tensor,
    *,
    eps: float = 1e-5,
    scale: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """`InstanceNorm3d` over the spatial dims of NDHWC `x`."""
    return tiled_instance_norm(x, (1, 1, 1), eps=eps, scale=scale, bias=bias)


def channel_demean(x: torch.Tensor) -> torch.Tensor:
    """Subtract each channel's spatial mean from NDHWC `x` (the ViT's
    'demean' output norm; `anatomix_tpu/ops/norms.py` channel_demean)."""
    return x - x.mean(dim=(1, 2, 3), keepdim=True)


def channel_layer_norm(x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """Per-voxel LayerNorm over the last (channel) axis, no affine (the
    ViT's ChannelLayerNorm; `anatomix_tpu/ops/norms.py`
    channel_layer_norm). Statistics and the normalize are f32 and the
    result is rounded once to `x.dtype`; the JAX package applies a bf16
    input's normalize in bf16, a difference below bf16 rounding."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm_train(
    x: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float = 1e-5,
    momentum: float = 0.1,
    group=None,
):
    """BatchNorm3d in train mode on channels-last `x` (`anatomix_tpu/ops/
    norms.py` batch_norm_train): normalize with the batch's statistics over
    every axis but the last (biased variance), statistics and the normalize
    in f32, the result in `x`'s dtype. Returns `(y, new_running_mean,
    new_running_var)`, the running stats updated with the unbiased variance
    and `momentum`, as torch does; they carry no gradient. The backward is
    torch autograd. With a process `group` (data parallelism: each rank
    holds an equal shard of the batch) the mean and the variance are those
    of the whole batch, averaged over the group by an autograd-aware
    all-reduce, so the backward reduces over the group too (JAX's
    `_bn_train_norm_bwd` psums its two sums), and the unbiased factor uses
    the whole batch's count."""
    dims = tuple(range(x.dim() - 1))
    x32 = x.float()
    n = x.numel() // x.shape[-1]
    mean = x32.mean(dim=dims)
    if group is not None:
        mean = group_mean(mean, group)
        n *= group_size(group)
    xc = x32 - mean
    var = xc.square().mean(dim=dims)
    if group is not None:
        var = group_mean(var, group)
    y = xc * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    with torch.no_grad():
        new_mean = (1 - momentum) * running_mean + momentum * mean
        new_var = ((1 - momentum) * running_var
                   + momentum * var * (n / max(n - 1, 1)))
    return y.to(x.dtype), new_mean, new_var
