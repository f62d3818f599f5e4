"""Whole-volume feature extraction with the anatomix models, on the card.

The port of `anatomix_tpu/extract.py`. For a UNet, eval-mode batch norm is
folded into the preceding convs, instance norm stays live, the model runs in
bf16 on the port's Hopper kernels (`models/unet_fused.py`), and the volume
goes through the model in one piece (`full`), in one piece with
instance-norm statistics per roi-sized tile (`full_tiled`), or as the
reference's Gaussian-blended sliding windows (`sliding`). The ViT
(`PrimusConfig`, `models/vit3d`) is bound to its 128^3 input and always
runs the sliding windows. On a `parallel.Mesh` of ranks, `sliding` shards
the windows and `full` the volume (`make_feature_extractor(mesh=...)`).
`record_function` ranges (opened only while a profiler runs,
`utils/profiling.annotate`): `extract/input` around the volume's
host-to-device copy (and `full`'s pad to the pooling stride) in every
extractor; `ops/sliding_window.py` and `models/unet_fused.py` open theirs
below it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.models.unet import (
    LayerSpec,
    Unet,
    UnetPlan,
    check_supported,
    deflate,
    lift_input,
)
from anatomix_tpu_torch.models.unet_fused import (
    prepack_fused,
    unet_apply_fused,
)
from anatomix_tpu_torch.models.unet_sharded import unet_apply_sharded
from anatomix_tpu_torch.models.vit3d import Primus, PrimusConfig
from anatomix_tpu_torch.ops.sliding_window import (
    scatter_kernel_eligible,
    sliding_window_inference,
)
from anatomix_tpu_torch.parallel.spatial import gather_d
from anatomix_tpu_torch.utils.profiling import annotate


def fold_batchnorm(plan: UnetPlan, state_dict: dict[str, torch.Tensor]):
    """Fold eval-mode batch norms into their preceding convs.

    Returns `(folded_plan, folded_state_dict)`; norm layers become
    'identity' so indices, and tap semantics, are preserved. A batch norm
    whose conv is a residual source stays live: the residual adds the
    conv's raw output, which a fold would replace by the normalized value
    (the JAX package's `fold_batchnorm` folds it all the same, ROADMAP
    F10)."""
    if plan.config.norm != "batch":
        return plan, dict(state_dict)
    new_layers = list(plan.layers)
    sd = dict(state_dict)
    prev_conv = None
    live = (set(plan.res_source) if plan.config.residual_connection
            else set())
    for idx, spec in enumerate(plan.layers):
        if spec.kind == "conv":
            prev_conv = idx
        elif spec.kind == "norm" and prev_conv not in live:
            base = f"model.{idx}"
            scale = sd.pop(f"{base}.weight").float()
            bias = sd.pop(f"{base}.bias").float()
            mean = sd.pop(f"{base}.running_mean").float()
            var = sd.pop(f"{base}.running_var").float()
            sd.pop(f"{base}.num_batches_tracked", None)
            inv = scale / torch.sqrt(var + plan.config.norm_eps)
            shift = bias - mean * inv
            cbase = f"model.{prev_conv}"
            w = sd[f"{cbase}.weight"].float()
            sd[f"{cbase}.weight"] = w * inv.reshape((-1,) + (1,) * (w.dim()
                                                                  - 1))
            old_b = sd.get(f"{cbase}.bias")
            sd[f"{cbase}.bias"] = shift if old_b is None else old_b + shift
            new_layers[idx] = LayerSpec("identity")
    return dataclasses.replace(plan, layers=tuple(new_layers)), sd


def spatial_sharded_unet(plan, state_dict, mesh, *, axis: str = "space",
                         compute_dtype: torch.dtype = torch.bfloat16):
    """`volume (1, D, H, W, C) -> features (1, D, H, W, out)` with D
    sharded over the mesh's `axis` (`anatomix_tpu/parallel/spatial.py`'s
    `spatial_sharded_unet`): every rank passes the whole volume, runs its
    shard (`models/unet_sharded.unet_apply_sharded`, batch norms folded,
    the weights on the mesh's device) and returns the gathered f32
    features. D must be divisible by (the axis size x 2^num_downs), so
    that every pool stays inside a shard."""
    n = mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    group = mesh.group(axis)
    stride = 2 ** plan.config.num_downs
    dev = mesh.device
    fplan, fsd = fold_batchnorm(
        plan, {k: v.to(dev) for k, v in state_dict.items()})
    packed = prepack_fused(fplan, fsd, device=dev,
                           compute_dtype=compute_dtype)

    @torch.inference_mode()
    def run(volume):
        with annotate("extract/input"):
            x = torch.as_tensor(volume, dtype=torch.float32, device=dev)
        D = x.shape[1]
        if D % (n * stride):
            raise ValueError(f"D={D} must be divisible by space axis ({n}) "
                             f"x 2^num_downs ({stride})")
        dl = D // n
        y = unet_apply_sharded(fplan, packed, x[:, i * dl:(i + 1) * dl],
                               group, compute_dtype=compute_dtype)
        return gather_d(y, group)

    return run


def minmax(arr: np.ndarray, minclip=None, maxclip=None) -> np.ndarray:
    """[0, 1] min-max normalization with optional clipping."""
    if not ((minclip is None) and (maxclip is None)):
        arr = np.clip(arr, minclip, maxclip)
    arr = arr.astype(np.float32)
    return (arr - arr.min()) / (arr.max() - arr.min())


def unit_normalize(feats: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Voxelwise unit L2 norm across channels."""
    norm = torch.linalg.vector_norm(feats.float(), dim=-1, keepdim=True)
    return (feats / torch.clamp(norm, min=eps)).to(feats.dtype)


def zscore_normalize(feats: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Voxelwise z-score across channels (population std)."""
    f32 = feats.float()
    mean = f32.mean(dim=-1, keepdim=True)
    std = f32.std(dim=-1, keepdim=True, correction=0)
    return ((f32 - mean) / (std + eps)).to(feats.dtype)


def _make_vit_extractor(cfg: PrimusConfig, state_dict, *, sw_batch_size,
                        overlap, mode, sigma_scale, compute_dtype, impl, dev,
                        mesh):
    """The ViT's sliding-window extractor (`anatomix_tpu/extract.py`
    make_feature_extractor's `PrimusConfig` branch): windows of
    `cfg.input_shape`; `impl='eager'` runs the plain versions in f32. As in
    JAX, the model emits the folded window rows (`emit="fold"`: the
    stage-wise decoder, its exit straight into the stitch) when
    `scatter_kernel_eligible` holds for the volume and the window."""
    if impl not in ("fused", "eager"):
        raise ValueError(f"unknown impl {impl!r}")
    plain = impl == "eager"
    cd = torch.float32 if plain else compute_dtype
    if dev.type == "cuda" and cd != torch.bfloat16 and not plain:
        raise ValueError("the ViT's kernels compute in bfloat16 on the card")
    model = Primus.from_state_dict(cfg, state_dict, device=dev)

    @torch.inference_mode()
    def extract(volume):
        with annotate("extract/input"):
            x = torch.as_tensor(volume, dtype=torch.float32, device=dev)
        emit = "fold" if scatter_kernel_eligible(
            max(x.shape[3], cfg.input_shape[2]), cfg.input_shape[2],
            cfg.num_classes) else "spatial"

        def window_fn(windows):
            return model(windows, compute_dtype=cd, plain=plain, emit=emit)

        return sliding_window_inference(
            x, window_fn, cfg.num_classes, roi_size=cfg.input_shape,
            sw_batch_size=sw_batch_size or 2, overlap=overlap, mode=mode,
            sigma_scale=sigma_scale, mesh=mesh,
        )

    return extract


def make_feature_extractor(
    plan: UnetPlan | PrimusConfig,
    state_dict: dict[str, Any],
    *,
    strategy: str = "sliding",
    roi_size=(128, 128, 128),
    sw_batch_size: int | None = None,
    overlap: float = 0.8,
    mode: str = "gaussian",
    sigma_scale: float = 0.25,
    compute_dtype: torch.dtype = torch.bfloat16,
    impl: str = "fused",
    device: str | torch.device = "cuda",
    mesh=None,
):
    """Build `volume (1, D, H, W, C) -> features (1, D, H, W, out)` (f32
    on `device`).

    A 1-D or 2-D UNet takes `(B, L, C)` or `(B, H, W, C)` and returns its
    features at that rank; its windows and tiles cut the real axes
    (`roi_size`'s last `dimension` extents).

    Strategies: 'sliding' (the reference's Gaussian-blended windows),
    'full' (one whole-volume forward, padded to a multiple of
    2**num_downs and cropped; for an instance-norm model the statistics
    are those of the whole volume), 'full_tiled' (the same forward with
    instance-norm statistics per tile: `max(1, round(s / roi))` tiles per
    padded axis, 2x2x2 for 256^3 at roi 128), 'auto' ('full' for
    batch/no norm, else 'sliding').

    `impl='fused'` runs the BN-folded forward on the port's kernels in
    `compute_dtype` (bf16 on the card; on the CPU the kernels' plain
    versions run, in f32 when asked). `impl='eager'` runs the plain
    f32 `Unet` module, the port's oracle path.

    A `PrimusConfig` plan (the ViT) always runs the sliding windows with
    windows of `plan.input_shape`, as the JAX package does: `strategy` and
    `roi_size` are ignored; `impl='eager'` runs each kernel's plain version
    in f32.

    With a `parallel.Mesh` (`mesh=`; every rank of it calls the extractor
    on the same volume and gets the whole result), 'sliding' shards the
    windows over the mesh's 'data' axis (`ops/sliding_window`), and 'full'
    on a mesh with a 'space' axis shards the volume's D axis over it with
    a halo exchange before every conv (`spatial_sharded_unet`; D
    divisible by the axis size x 2**num_downs). The model runs on the
    mesh's device.
    """
    dev = resolve_device(device if mesh is None else mesh.device)
    if isinstance(plan, PrimusConfig):
        return _make_vit_extractor(
            plan, state_dict, sw_batch_size=sw_batch_size, overlap=overlap,
            mode=mode, sigma_scale=sigma_scale, compute_dtype=compute_dtype,
            impl=impl, dev=dev, mesh=mesh)
    check_supported(plan.config)
    if strategy == "auto":
        strategy = (
            "full" if plan.config.norm in ("batch", "none") else "sliding"
        )
    if strategy not in ("full", "full_tiled", "sliding"):
        raise ValueError(f"Unknown strategy: {strategy}")
    if (strategy == "full" and mesh is not None
            and "space" in mesh.axis_names):
        if impl != "fused":
            raise ValueError("the spatially sharded forward runs the "
                             "kernels (impl='fused')")
        if dev.type == "cuda" and compute_dtype != torch.bfloat16:
            raise ValueError("the conv kernels compute in bfloat16 on the card")
        return spatial_sharded_unet(plan, state_dict, mesh,
                                    compute_dtype=compute_dtype)
    sd = {k: v.to(dev) for k, v in state_dict.items()}
    if impl == "fused":
        if dev.type == "cuda" and compute_dtype != torch.bfloat16:
            raise ValueError("the conv kernels compute in bfloat16 on the card")
        fplan, fsd = fold_batchnorm(plan, sd)
        packed = prepack_fused(fplan, fsd, device=dev,
                               compute_dtype=compute_dtype)

        def model_fn(x, tile_counts=None):
            return unet_apply_fused(fplan, packed, x,
                                    compute_dtype=compute_dtype,
                                    in_tile_counts=tile_counts)
    elif impl == "eager":
        net = Unet.from_state_dict(plan, sd).to(dev)

        def model_fn(x, tile_counts=None):
            return net(x.float(), in_tile_counts=tile_counts)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    cfg = plan.config
    out_channels = cfg.output_nc
    stride = 2 ** cfg.num_downs
    dim, off = cfg.dimension, 3 - cfg.dimension

    @torch.inference_mode()
    def extract(volume):
        full = strategy in ("full", "full_tiled")
        with annotate("extract/input"):
            x = torch.as_tensor(volume, dtype=torch.float32, device=dev)
            if full:
                pads, crops = [], []
                for s in x.shape[1:1 + dim]:
                    pad = (-s) % stride
                    pads.append((pad // 2, pad - pad // 2))
                    crops.append(slice(pad // 2, pad // 2 + s))
                if any(p != (0, 0) for p in pads):
                    x = F.pad(x, (0, 0) + tuple(
                        v for p in reversed(pads) for v in p))
        if full:
            tile_counts = None
            if strategy == "full_tiled":
                tile_counts = (1,) * off + tuple(
                    max(1, round(s / r)) for s, r in
                    zip(x.shape[1:1 + dim], tuple(roi_size)[-dim:]))
            y = model_fn(x, tile_counts)
            return y[(slice(None), *crops)]
        if not off:
            return sliding_window_inference(
                x, model_fn, out_channels, roi_size=roi_size,
                sw_batch_size=sw_batch_size or 2, overlap=overlap,
                mode=mode, sigma_scale=sigma_scale, mesh=mesh,
            )
        # a 1-D or 2-D net's windows: the lifted volume with the batch on
        # its first axis, windows of extent 1 on the lifted axes
        y = sliding_window_inference(
            x.reshape((1, x.shape[0]) + (1,) * (off - 1) + x.shape[1:]),
            lambda w: lift_input(cfg, model_fn(deflate(cfg, w))),
            out_channels, roi_size=(1,) * off + tuple(roi_size)[-dim:],
            sw_batch_size=sw_batch_size or 2, overlap=overlap, mode=mode,
            sigma_scale=sigma_scale, mesh=mesh,
        )
        return y.reshape(x.shape[:1] + y.shape[1 + off:])

    return extract


def extract_features(
    img_fixed: np.ndarray,
    img_moving: np.ndarray,
    plan: UnetPlan | PrimusConfig,
    state_dict: dict[str, Any],
    fixminclip=None,
    fixmaxclip=None,
    movminclip=None,
    movmaxclip=None,
    **extractor_kwargs,
):
    """Reference-compatible two-volume feature extraction; returns
    channels-last f32 tensors (1, D, H, W, out)."""
    extractor = make_feature_extractor(plan, state_dict, **extractor_kwargs)
    fixed = minmax(img_fixed, fixminclip, fixmaxclip)[None, ..., None]
    moving = minmax(img_moving, movminclip, movmaxclip)[None, ..., None]
    return extractor(fixed), extractor(moving)
