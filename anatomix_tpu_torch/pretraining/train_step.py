"""The pretraining train step (the port of `anatomix_tpu/pretraining/
train_step.py`, the reference's `SupCLModel.optimize_parameters` and
`calculate_NCE_loss`).

Forward the two views through the backbone as one batch, collecting the tap
activations (the UNet's taps, or the ViT's single tap: its output
volume); sample per-sample patch coordinates shared by the views; project
with the per-tap MLPs; sum the per-tap SupPatchNCE losses (weights
default to 1 / number of taps); take one AdamW step on both networks.

The optimizer reproduces the JAX package's optax chain: optionally
`clip_by_global_norm` before `adamw` (eps 1e-8 outside the square root,
decoupled decay `lr * wd * p`), on the trainable leaves only; batch-norm
running stats and frozen layers get a hard zero update; `MultiSteps`
averages `grad_accum` gradients before an update. The step runs eagerly;
convs of the UNet run on the conv kernels and their backward kernels
(`kernels/conv_train.py`), in bf16 with f32 accumulation (a live instance
norm's convs on the three-term split); the norms, the projector, the loss
and the optimizer in f32. The 6M family takes the block walk
(`models/unet_train_block.py`), every other UNet the general walk
(`models/unet_train.py`). The ViT (`plan` a
`PrimusConfig`) runs `models/vit3d/primus_train.primus_train_apply`: its
convs and attention on the kernels and their backward kernels, the rest in
f32; every ViT leaf is trainable.

Trees are nested dicts and lists of tensors: `params_g` is the UNet's
reference-keyed state dict (`model.<idx>.weight`, `.running_mean`, ...) or
the ViT's state dict (`Primus.state_dict()` keys), `params_f` maps
`mlp_<t>` to `{"linears": [...], "bns": [...]}`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from anatomix_tpu_torch.device import resolve_device
from anatomix_tpu_torch.models.unet import (
    UnetPlan,
    init_params,
    trainable_state,
)
from anatomix_tpu_torch.models.unet_train import unet_train_forward
from anatomix_tpu_torch.models.vit3d.primus import (
    PrimusConfig,
    init_primus_params,
)
from anatomix_tpu_torch.models.vit3d.primus_train import primus_train_apply
from anatomix_tpu_torch.pretraining.losses import sup_patch_nce_loss
from anatomix_tpu_torch.pretraining.patch_sample import (
    apply_patch_mlp,
    gather_at_coords,
    init_patch_mlps,
    labels_at_coords,
    nearest_downsample,
    sample_patch_coords,
    skip_patch_draw,
)
from anatomix_tpu_torch.utils.profiling import annotate

_STAT_NAMES = ("mean", "var", "running_mean", "running_var")


# -----------------------------------------------------------------------------
# trees of tensors

def tree_items(tree: Any, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]/")
    else:
        yield prefix[:-1], tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leafwise to trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm)."""
    leaves = [v.float() for _, v in tree_items(tree)]
    return torch.sqrt(sum(v.square().sum() for v in leaves))


# -----------------------------------------------------------------------------
# state and optimizer

@dataclasses.dataclass
class TrainState:
    step: int
    params_g: dict[str, torch.Tensor]
    params_f: dict[str, Any]
    opt_state_g: dict[str, Any]
    opt_state_f: dict[str, Any]
    # host-driven learning-rate multiplier on top of the schedule (the
    # `lr_policy=plateau` hook)
    lr_scale: float = 1.0


def _layer_of(path: str) -> str | None:
    m = re.match(r"model\.(\d+)\.", path)
    return m.group(1) if m else None


def _trainable_mask(params: Any, frozen_layers: Sequence[int] = ()) -> Any:
    """False for batch-norm running stats (not optimizer targets; weight
    decay must not touch them) and for the leaves of frozen layers."""
    frozen = {str(i) for i in frozen_layers}

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{path}[{i}]/") for i, v in enumerate(tree)]
        name = path[:-1]
        if name.split("/")[-1].split(".")[-1] in _STAT_NAMES:
            return False
        return _layer_of(name) not in frozen if frozen else True

    return walk(params, "")


def frozen_layer_ids(plan: UnetPlan, unfreeze_layers, tap_layers):
    """Layer ids frozen when `unfreeze_layers` is set: every parameterized
    layer up to the last tap except those listed."""
    if not unfreeze_layers:
        return ()
    keep = {int(i) for i in unfreeze_layers}
    last = max(tap_layers)
    return tuple(
        i for i, s in enumerate(plan.layers)
        if s.kind in ("conv", "norm") and i <= last and i not in keep
    )


def init_opt_state(params: Any, grad_accum: int = 1) -> dict[str, Any]:
    """Fresh AdamW state: zero moments, count 0 (and the MultiSteps
    accumulator when `grad_accum > 1`)."""
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    state = {"count": 0, "mu": tree_map(zeros, params),
             "nu": tree_map(zeros, params)}
    if grad_accum > 1:
        state.update(mini_step=0, acc=tree_map(zeros, params))
    return state


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax `adamw` (after `clip_by_global_norm` when `grad_clip` is set)
    on the leaves `mask` marks trainable, a zero update elsewhere, wrapped
    in `MultiSteps` when `grad_accum > 1`."""

    schedule: Callable[[int], float]
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 1e-5
    eps: float = 1e-8
    grad_clip: float | None = None
    mask: Any = None
    grad_accum: int = 1

    def update(self, grads, state, params):
        """Returns `(new_params, new_state)`."""
        state = dict(state)
        if self.grad_accum > 1:
            n = state["mini_step"]
            acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads,
                           state["acc"])
            if n < self.grad_accum - 1:
                state.update(mini_step=n + 1, acc=acc)
                return params, state
            grads = acc
            state.update(mini_step=0, acc=tree_map(torch.zeros_like, acc))
        mask = (self.mask if self.mask is not None
                else tree_map(lambda _: True, params))
        if self.grad_clip is not None:
            g_norm = global_norm(
                [g for (_, g), (_, m) in zip(tree_items(grads),
                                             tree_items(mask)) if m])
            keep = g_norm < self.grad_clip
            grads = tree_map(
                lambda g: torch.where(keep, g, g / g_norm * self.grad_clip),
                grads)
        count = state["count"] + 1
        c1 = 1.0 - self.beta1 ** count
        c2 = 1.0 - self.beta2 ** count
        lr = self.schedule(state["count"])
        b1, b2 = self.beta1, self.beta2
        mu = tree_map(lambda g, m_, m: (1 - b1) * g + b1 * m_ if m else m_,
                      grads, state["mu"], mask)
        nu = tree_map(
            lambda g, v_, m: (1 - b2) * g.square() + b2 * v_ if m else v_,
            grads, state["nu"], mask)

        def apply(p, m_, v_, m):
            if not m:
                return p
            u = (m_ / c1) / (torch.sqrt(v_ / c2) + self.eps)
            u = u + self.weight_decay * p
            return p + u * (-lr)

        params = tree_map(apply, params, mu, nu, mask)
        state.update(count=count, mu=mu, nu=nu)
        return params, state


def make_optimizer(
    lr: float = 2e-4,
    *,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-5,
    grad_clip: float | None = None,
    schedule: Callable[[int], float] | None = None,
    mask: Any = None,
    grad_accum: int = 1,
) -> AdamW:
    """AdamW with the reference's settings (`supcl_model.py` optimizer_G /
    optimizer_F), optional global-norm clipping and gradient
    accumulation."""
    return AdamW(
        schedule=schedule if schedule is not None else (lambda count: lr),
        beta1=beta1, beta2=beta2, weight_decay=weight_decay,
        grad_clip=grad_clip, mask=mask, grad_accum=grad_accum,
    )


def backbone_tap_channels(plan, tap_layers) -> tuple[int, ...]:
    """Channels of each tap: the UNet's, or the ViT's `num_classes`."""
    if isinstance(plan, PrimusConfig):
        return (plan.num_classes,)
    return plan.tap_channels(tuple(tap_layers))


def init_train_state(
    plan: UnetPlan | PrimusConfig,
    generator: torch.Generator,
    *,
    tap_layers: Sequence[int],
    netf_nc: int = 256,
    n_mlps: int = 3,
    init_type: str = "kaiming",
    init_gain: float = 0.02,
    grad_accum: int = 1,
    device: str | torch.device = "cuda",
) -> TrainState:
    """Seeded parameters of G and F (drawn on the CPU from `generator`, G
    first: the UNet's `init_params` or the ViT's `init_primus_params`, which
    ignores `init_type` and `init_gain` as the JAX package does) and fresh
    optimizer states, on `device` (the card unless the caller asks for the
    CPU; raises without one)."""
    device = resolve_device(device)
    if isinstance(plan, PrimusConfig):
        params_g = init_primus_params(plan, generator)
    else:
        params_g = trainable_state(plan, init_params(
            plan, generator, init_type=init_type, init_gain=init_gain))
    params_f = init_patch_mlps(
        generator, backbone_tap_channels(plan, tap_layers), nc=netf_nc,
        n_mlps=n_mlps, init_type=init_type, init_gain=init_gain,
    )
    to_dev = lambda t: t.to(device)  # noqa: E731
    params_g = tree_map(to_dev, params_g)
    params_f = tree_map(to_dev, params_f)
    return TrainState(
        step=0, params_g=params_g, params_f=params_f,
        opt_state_g=init_opt_state(params_g, grad_accum),
        opt_state_f=init_opt_state(params_f, grad_accum),
    )


# -----------------------------------------------------------------------------
# loss

@dataclasses.dataclass(frozen=True)
class NCEOptions:
    temperature: float = 0.33
    lambda_nce: float = 1.0
    weigh_rarity: bool = False
    balance_denominator: bool = False
    weighting_mode: str = "raw"


def _backbone_forward(plan, params_g, x, tap_layers, train, compute_dtype,
                      eval_norm_layers, plain, bn_group=None):
    """`(taps, new_g_stats)`: the UNet's train walk (the 6M family's block
    walk, or the general walk for every other UNet), or the ViT's output
    volume as its single tap (the JAX package's `_backbone_forward`)."""
    if isinstance(plan, PrimusConfig):
        return [primus_train_apply(plan, params_g, x,
                                   compute_dtype=compute_dtype,
                                   plain=plain)], {}
    if not isinstance(plan, UnetPlan):
        raise NotImplementedError(
            "the port's pretraining step covers the UNets and the Primus ViT")
    if not train:
        eval_norm_layers = [i for i, s in enumerate(plan.layers)
                            if s.kind == "norm"]
    _, taps, new_g_stats = unet_train_forward(
        plan, params_g, x, layers=tap_layers,
        eval_norm_layers=eval_norm_layers, compute_dtype=compute_dtype,
        plain=plain, bn_group=bn_group,
    )
    return taps, new_g_stats


def nce_forward(
    plan: UnetPlan | PrimusConfig,
    params_g,
    params_f,
    views: torch.Tensor,  # (B, 2, D, H, W, C)
    segs: torch.Tensor,  # (B, D, H, W, 1) integer labels
    generator: torch.Generator,
    *,
    tap_layers: Sequence[int],
    num_patches: int,
    nce: NCEOptions,
    nce_weights: Sequence[float] | None = None,
    train: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    eval_norm_layers: Sequence[int] = (),
    fg_masks: torch.Tensor | None = None,  # (B, D, H, W) > 0 = foreground
    plain: bool = False,
    mesh=None,
):
    """The multi-tap SupPatchNCE loss; returns `(loss, aux)` with aux =
    {new_g_stats, new_f_stats, per_layer}. With `fg_masks`, patches come
    from the foreground, the mask nearest-downsampled to each tap's grid.
    `plain=True` runs the backbone's f32 reference path (`F.conv3d`, and
    for the ViT einsum/softmax attention).

    With a `parallel.Mesh`, `views` and `segs` are this rank's contiguous
    shard of a global batch split over the mesh's 'data' axis: the batch
    norms (backbone and projector) take the global batch's statistics, the
    patch sampler draws for every sample of the global batch in the
    single-device order (tap, then sample) and keeps its own rows, and the
    loss and per-tap losses returned are this rank's share of the global
    mean (local sum / global B): summed over the ranks they are the global
    batch's."""
    tap_layers = tuple(tap_layers)
    B = views.shape[0]
    group, B_all, first = None, B, 0
    if mesh is not None:
        group = mesh.group("data")
        B_all = B * mesh.axis_size("data")
        first = B * mesh.axis_index("data")
    x = torch.cat([views[:, 0], views[:, 1]], dim=0)  # (2B, ...)
    with annotate("step/forward"):
        taps, new_g_stats = _backbone_forward(
            plan, params_g, x, tap_layers, train, compute_dtype,
            eval_norm_layers, plain, bn_group=group)
    if nce_weights is None:
        nce_weights = [1.0 / len(tap_layers)] * len(tap_layers)

    total = 0.0
    per_layer = {}
    new_f_stats = {}
    seg3d = segs[..., 0]
    for t, (layer_id, feat, w_t) in enumerate(
            zip(tap_layers, taps, nce_weights)):
        tap_spatial = tuple(feat.shape[1:4])
        with annotate("step/sampler"):
            drawn = []
            for b_all in range(B_all):
                b = b_all - first
                if not 0 <= b < B:  # another rank's sample
                    skip_patch_draw(generator, tap_spatial)
                    continue
                drawn.append(sample_patch_coords(
                    generator, tap_spatial, num_patches,
                    mask=(None if fg_masks is None
                          else nearest_downsample(fg_masks[b], tap_spatial))))
            coords = torch.stack(drawn).to(feat.device)  # (B, P, 3)
        with annotate("step/loss"):
            g1 = torch.stack([gather_at_coords(feat[b], coords[b])
                              for b in range(B)])
            g2 = torch.stack([gather_at_coords(feat[B + b], coords[b])
                              for b in range(B)])
            stacked = torch.stack([g1, g2], dim=1)  # (B, 2, P, ch)
            P = stacked.shape[2]
            proj, f_stats = apply_patch_mlp(
                params_f[f"mlp_{t}"], stacked.reshape(B * 2 * P, -1),
                train=train, group=group)
            new_f_stats[f"mlp_{t}"] = {
                "linears": params_f[f"mlp_{t}"]["linears"], "bns": f_stats}
            proj = proj.reshape(B, 2, P, -1)
            loss_t = torch.stack([
                sup_patch_nce_loss(
                    proj[b],
                    labels_at_coords(seg3d[b], coords[b], tap_spatial),
                    temperature=nce.temperature,
                    weigh_rarity=nce.weigh_rarity,
                    balance_denominator=nce.balance_denominator,
                    weighting_mode=nce.weighting_mode,
                )
                for b in range(B)
            ]).mean()
            if group is not None:
                # this rank's share of the global mean (times 1.0 at a
                # world of one: the same bits as the mean)
                loss_t = loss_t * (B / B_all)
            total = total + loss_t * w_t * nce.lambda_nce
            per_layer[str(layer_id)] = loss_t
    aux = {"new_g_stats": new_g_stats, "new_f_stats": new_f_stats,
           "per_layer": per_layer}
    return total, aux


def nce_loss_and_grads(plan, params_g, params_f, views, segs, generator,
                       **kwargs):
    """`nce_forward` and the gradients of its loss with respect to every
    float leaf of `params_g` and `params_f` (zeros where unused). Returns
    `(loss, aux, grads_g, grads_f)`; the loss and aux carry no graph."""
    leaves_g = tree_map(lambda p: p.detach().requires_grad_(), params_g)
    leaves_f = tree_map(lambda p: p.detach().requires_grad_(), params_f)
    loss, aux = nce_forward(plan, leaves_g, leaves_f, views, segs,
                            generator, **kwargs)
    flat = [v for _, v in tree_items(leaves_g)] + [
        v for _, v in tree_items(leaves_f)]
    with annotate("step/backward"):
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    it = iter(grads)
    by_id = {id(p): next(it) for p in flat}
    grads_g = tree_map(lambda p: by_id[id(p)], leaves_g)
    grads_f = tree_map(lambda p: by_id[id(p)], leaves_f)
    aux = tree_map(lambda v: v.detach() if torch.is_tensor(v) else v, aux)
    return loss.detach(), aux, grads_g, grads_f


# gradients all-reduce in flat buckets of at most this many f32 values
GRAD_BUCKET_ELEMS = 1 << 24


def all_reduce_flat(tensors, group):
    """Sum each of `tensors` (one dtype) over `group` in place, packed into
    flat buckets of at most `GRAD_BUCKET_ELEMS` values, one all-reduce
    each."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) > 1:
        raise ValueError(f"one dtype per all-reduce, got {dtypes}")
    i = 0
    while i < len(tensors):
        j, n = i, 0
        while j < len(tensors) and (
                j == i or n + tensors[j].numel() <= GRAD_BUCKET_ELEMS):
            n += tensors[j].numel()
            j += 1
        flat = torch.cat([t.reshape(-1) for t in tensors[i:j]])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for t in tensors[i:j]:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        i = j


def _merge_bn_stats(params_g, new_g_stats):
    merged = dict(params_g)
    for idx, (mean, var) in new_g_stats.items():
        merged[f"model.{idx}.running_mean"] = mean
        merged[f"model.{idx}.running_var"] = var
    return merged


def build_train_step(
    plan: UnetPlan | PrimusConfig,
    *,
    tap_layers: Sequence[int],
    num_patches: int = 512,
    nce_temperature: float = 0.33,
    lambda_nce: float = 1.0,
    weigh_rarity: bool = False,
    balance_denominator: bool = False,
    weighting_mode: str = "raw",
    nce_weights: Sequence[float] | None = None,
    lr: float = 2e-4,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-5,
    grad_clip: float | None = None,
    grad_clip_f: float | None = None,
    grad_accum: int = 1,
    schedule: Callable[[int], float] | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    frozen_layers: Sequence[int] = (),
    use_fg_mask: bool = False,
    plain: bool = False,
    mesh=None,
):
    """The train step `(state, views, segs, generator) -> (state,
    metrics)`; `views` (B, 2, D, H, W, 1) and `segs` (B, D, H, W, 1) are
    moved to the parameters' device. Metrics (0-d tensors and floats):
    loss, grad_norm_G, grad_norm_F, lr and nce_<layer>. `plain=True` runs
    the backbone's f32 reference path (`nce_forward`'s), the route the
    kernels' multi-step curve is held against.

    With a `parallel.Mesh` (data parallelism, `anatomix_tpu/pretraining/
    train_step.py:388-521`): each rank passes its contiguous shard of the
    global batch (`parallel.shard_batch`), the same state and a generator
    in the same state; `nce_forward` gives each rank its share of the
    global loss, every G and F gradient is summed over the 'data' group in
    flat buckets (`all_reduce_flat`) before AdamW, and the metrics (loss,
    per-tap losses, the gradient norms after the reduce) are the global
    batch's. The batch norms' running statistics come out the same on
    every rank, so the states stay replicas."""
    nce = NCEOptions(
        temperature=nce_temperature, lambda_nce=lambda_nce,
        weigh_rarity=weigh_rarity, balance_denominator=balance_denominator,
        weighting_mode=weighting_mode,
    )
    opt_common = dict(beta1=beta1, beta2=beta2, weight_decay=weight_decay,
                      grad_accum=grad_accum)
    eval_norms = tuple(i for i in frozen_layers
                       if plan.layers[i].kind == "norm")

    def step(state: TrainState, views, segs, generator):
        dev = next(iter(state.params_g.values())).device
        views = torch.as_tensor(views, device=dev)
        segs = torch.as_tensor(segs, device=dev)

        def scaled_schedule(count):
            base = schedule(count) if schedule is not None else lr
            return base * state.lr_scale

        loss, aux, grads_g, grads_f = nce_loss_and_grads(
            plan, state.params_g, state.params_f, views, segs, generator,
            tap_layers=tap_layers, num_patches=num_patches, nce=nce,
            nce_weights=nce_weights, train=True,
            compute_dtype=compute_dtype, eval_norm_layers=eval_norms,
            # label > 0 is the foreground mask
            fg_masks=(segs[..., 0] > 0) if use_fg_mask else None,
            plain=plain, mesh=mesh,
        )
        if mesh is not None:
            with annotate("step/all_reduce"):
                group = mesh.group("data")
                all_reduce_flat([g for _, g in tree_items(grads_g)]
                                + [g for _, g in tree_items(grads_f)], group)
                per = aux["per_layer"]
                summed = torch.stack([loss] + [per[k] for k in per])
                dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
                loss = summed[0]
                aux["per_layer"] = {k: summed[1 + i]
                                    for i, k in enumerate(per)}
        tx_g = make_optimizer(
            lr, grad_clip=grad_clip, schedule=scaled_schedule,
            mask=_trainable_mask(state.params_g, frozen_layers),
            **opt_common)
        tx_f = make_optimizer(
            lr, grad_clip=grad_clip_f if grad_clip_f is not None
            else grad_clip, schedule=scaled_schedule,
            mask=_trainable_mask(state.params_f), **opt_common)
        with annotate("step/optimizer"):
            params_g, opt_state_g = tx_g.update(grads_g, state.opt_state_g,
                                                state.params_g)
            params_f, opt_state_f = tx_f.update(grads_f, state.opt_state_f,
                                                state.params_f)
        params_g = _merge_bn_stats(params_g, aux["new_g_stats"])
        # projector: new running stats, optimizer-updated scale and bias
        params_f = {
            name: {
                "linears": params_f[name]["linears"],
                "bns": [
                    {**new_bn, **{k: v for k, v in opt_bn.items()
                                  if k in ("scale", "bias")}}
                    for new_bn, opt_bn in zip(sub["bns"],
                                              params_f[name]["bns"])
                ],
            }
            for name, sub in aux["new_f_stats"].items()
        }
        metrics = {
            "loss": loss,
            "grad_norm_G": global_norm(grads_g),
            "grad_norm_F": global_norm(grads_f),
            "lr": scaled_schedule(state.step),
            **{f"nce_{k}": v for k, v in aux["per_layer"].items()},
        }
        new_state = TrainState(
            step=state.step + 1, params_g=params_g, params_f=params_f,
            opt_state_g=opt_state_g, opt_state_f=opt_state_f,
            lr_scale=state.lr_scale,
        )
        return new_state, metrics

    return step
