"""Patch sampling and the per-tap projector MLPs (the port of
`anatomix_tpu/pretraining/patch_sample.py`, the reference's `PatchSampleF`).

* MLP input widths are static, from the UNet plan's tap channels.
* Coordinates are a uniform sample without replacement, drawn from a
  `torch.Generator` as Gumbel top-k: min(num_patches, voxels) per tap,
  shared by the two views. With a mask, background scores get -1e4, so
  foreground wins and a short foreground is filled with background voxels.
* The projector is Linear(no bias) -> BatchNorm1d -> ReLU (x1 or x2) ->
  Linear(no bias) -> BatchNorm1d(affine=False), in f32; in train mode the
  batch norm normalizes with the biased variance over the (views x
  patches) rows and updates its running stats with the unbiased one.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from anatomix_tpu_torch.parallel.mesh import group_mean, group_size


def init_patch_mlps(
    generator: torch.Generator,
    tap_channels: Sequence[int],
    *,
    nc: int = 256,
    n_mlps: int = 3,
    init_type: str = "kaiming",
    init_gain: float = 0.02,
) -> dict[str, Any]:
    """Per-tap projector parameters, keyed 'mlp_<i>' (CPU, f32): linears
    (in, out) and batch norms {mean, var[, scale, bias]}."""
    if n_mlps not in (2, 3):
        raise NotImplementedError("n_mlps must be 2 or 3")
    params: dict[str, Any] = {}
    for i, cin in enumerate(tap_channels):
        widths = [cin] + [nc] * n_mlps
        linears, bns = [], []
        for j in range(n_mlps):
            fan_in, fan_out = widths[j], widths[j + 1]
            if init_type == "kaiming":
                std = (2.0 / fan_in) ** 0.5
            elif init_type == "xavier":
                std = init_gain * (2.0 / (fan_in + fan_out)) ** 0.5
            else:  # normal
                std = init_gain
            linears.append(
                torch.randn((fan_in, fan_out), generator=generator) * std)
            bn = {"mean": torch.zeros(fan_out), "var": torch.ones(fan_out)}
            if j < n_mlps - 1:  # the final norm has affine=False
                bn["scale"] = 1.0 + torch.randn(
                    (fan_out,), generator=generator) * init_gain
                bn["bias"] = torch.zeros(fan_out)
            bns.append(bn)
        params[f"mlp_{i}"] = {"linears": linears, "bns": bns}
    return params


def _bn1d(x, bn, *, train: bool, eps: float, momentum: float = 0.1,
          group=None):
    """BatchNorm1d over axis 0; returns (y, new running stats or None).
    With a process `group` (data parallelism: each rank holds an equal
    share of the rows) the statistics are those of every rank's rows,
    averaged by an autograd-aware all-reduce, and the unbiased factor uses
    their count."""
    if train:
        n = x.shape[0]
        mean = x.mean(dim=0)
        if group is not None:
            mean = group_mean(mean, group)
            n *= group_size(group)
        var = (x - mean).square().mean(dim=0)
        if group is not None:
            var = group_mean(var, group)
        with torch.no_grad():
            new = {
                "mean": (1 - momentum) * bn["mean"] + momentum * mean,
                "var": ((1 - momentum) * bn["var"]
                        + momentum * var * (n / max(n - 1, 1))),
            }
    else:
        mean, var = bn["mean"], bn["var"]
        new = None
    y = (x - mean) * torch.rsqrt(var + eps)
    if "scale" in bn:
        y = y * bn["scale"] + bn["bias"]
    return y, new


def apply_patch_mlp(
    mlp_params: dict[str, Any],
    x: torch.Tensor,  # (N, C_in) flattened patch features
    *,
    train: bool = True,
    eps: float = 1e-5,
    group=None,
):
    """Project patch features in f32; returns (y (N, nc), the batch norms
    with their running stats updated in train mode). `group`: the batch
    norms' statistics over the rows of every rank of it (`_bn1d`)."""
    new_stats = []
    n = len(mlp_params["linears"])
    x = x.float()
    for j, (w, bn) in enumerate(zip(mlp_params["linears"],
                                    mlp_params["bns"])):
        x = x @ w.float()
        x, upd = _bn1d(x, bn, train=train, eps=eps, group=group)
        new_stats.append({**bn, **upd} if upd is not None else bn)
        if j < n - 1:
            x = torch.relu(x)
    return x, new_stats


def sample_patch_coords(
    generator: torch.Generator,
    spatial: tuple[int, int, int],
    num_patches: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """min(num_patches, voxels) distinct voxel coords, (P, 3) int64 on the
    generator's device: uniform without replacement over all voxels, or
    over the voxels where `mask > 0` first (the rest filled uniformly from
    the background when the foreground is short)."""
    d, h, w = spatial
    n = d * h * w
    p = min(num_patches, n)
    u = torch.rand((n,), generator=generator, device=generator.device)
    score = -torch.log(-torch.log(u))  # Gumbel(0, 1)
    if mask is not None:
        # -1e4 keeps f32's spacing (~1e-3) below the Gumbel noise, so the
        # background fill stays uniform, while any foreground score wins
        score = score + torch.where(mask.reshape(-1) > 0, 0.0, -1e4)
    flat = torch.topk(score, p).indices
    return torch.stack([flat // (h * w), (flat // w) % h, flat % w], dim=-1)


def skip_patch_draw(generator: torch.Generator,
                    spatial: tuple[int, int, int]) -> None:
    """Advance `generator` as `sample_patch_coords` does for a tap grid of
    `spatial`, drawing nothing else: under data parallelism a rank takes
    this for each sample of the global batch that another rank holds, so
    every rank's generator stays where a single device's would."""
    d, h, w = spatial
    torch.rand((d * h * w,), generator=generator, device=generator.device)


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """torch `F.interpolate(mode='nearest')` source index floor(i * N / n),
    in f32 as the JAX package computes it."""
    return (torch.arange(n_out, dtype=torch.float32, device=device)
            * (n_in / n_out)).long()


def nearest_downsample(vol: torch.Tensor,
                       tap_spatial: tuple[int, int, int]) -> torch.Tensor:
    """Nearest-downsample a (D, H, W) volume to a tap grid (out[i] =
    in[floor(i * D / d)])."""
    D, H, W = vol.shape
    d, h, w = tap_spatial
    if D % d == 0 and H % h == 0 and W % w == 0:
        return vol[::D // d, ::H // h, ::W // w]
    iz, iy, ix = (_nearest_index(a, b, vol.device)
                  for a, b in ((D, d), (H, h), (W, w)))
    return vol[iz][:, iy][:, :, ix]


def gather_at_coords(feat: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Gather (D, H, W, C) features at (P, 3) coords -> (P, C)."""
    D, H, W, C = feat.shape
    flat = (coords[:, 0] * H + coords[:, 1]) * W + coords[:, 2]
    return feat.reshape(-1, C).index_select(0, flat)


def labels_at_coords(
    seg: torch.Tensor,  # (D, H, W) integer labels at full resolution
    coords: torch.Tensor,  # (P, 3) coords in the tap grid
    tap_spatial: tuple[int, int, int],
) -> torch.Tensor:
    """Labels of sampled tap-grid voxels under nearest downsampling: the
    full-resolution seg gathered at the scaled coords."""
    D, H, W = seg.shape
    scaled = []
    for ax, (n_in, n_out) in enumerate(zip((D, H, W), tap_spatial)):
        c = coords[:, ax]
        if n_in % n_out == 0:
            scaled.append(c * (n_in // n_out))
        else:
            scaled.append((c.float() * (n_in / n_out)).long())
    cz, cy, cx = scaled
    return seg.reshape(-1).index_select(0, (cz * H + cy) * W + cx)
