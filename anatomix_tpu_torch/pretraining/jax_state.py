"""A JAX run's train state (`latest_train_state.npz` of ordered leaves) as
the port's `TrainState`.

The JAX trainer saves its `TrainState` as the leaves of its pytree in
flatten order, `leaf_0` ... `leaf_{n-1}` (`anatomix_tpu/utils/checkpoint.py`
save_state_leaves), which only the treedef of a state built the same way
can read. The port has no treedef: `jax_state_keys` writes the order out
as a list of names, from the plan's parameters and the optimizer settings,
following the JAX package's `TrainState` (`anatomix_tpu/pretraining/
train_step.py:98-108`: step, params_g, params_f, opt_state_g, opt_state_f,
lr_scale) and its `make_optimizer` (`:141-182`), whose state is optax's:

- `multi_transform` with the labels of `_trainable_mask` (`:111-124`: batch
  norm running stats and the frozen layers `freeze`, the rest `train`):
  `MultiTransformState` holds one `MaskedState` per label in sorted order;
  `freeze`'s `set_to_zero` keeps nothing, `train`'s holds the chain below
  with its masked-out leaves as empty `MaskedNode`s;
- the chain: `clip_by_global_norm` (when `grad_clip` is set; keeps
  nothing), then `adamw`: `ScaleByAdamState(count, mu, nu)`, the decay's
  empty state, the schedule's `ScaleByScheduleState(count)`;
- `MultiSteps` around it all when `grad_accum > 1`: `MultiStepsState(
  mini_step, gradient_step, inner_opt_state, acc_grads, skip_state=())`,
  `acc_grads` over every leaf.

Dicts flatten in sorted key order and lists in order, which is the port's
`tree_items` order, so the parameter paths come from the JAX-layout trees
the port's converters build (`models/convert.to_jax_params`,
`vit3d/convert.to_jax_primus_params`). The CPU tests hold the list to the
JAX package's own `load_state_leaves`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from anatomix_tpu_torch.models.unet import UnetPlan, trainable_state
from anatomix_tpu_torch.pretraining.train_step import (
    TrainState,
    tree_items,
    tree_map,
)

_STATS = ("mean", "var")


def _jax_params_g(plan, params_g) -> dict:
    """The port's `params_g` as the JAX package's nested tree (numpy)."""
    if isinstance(plan, UnetPlan):
        from anatomix_tpu_torch.models.convert import to_jax_params

        return to_jax_params(plan, params_g)
    from anatomix_tpu_torch.models.vit3d.convert import to_jax_primus_params

    return to_jax_primus_params(plan, params_g)


def _from_jax_params_g(plan, tree) -> dict[str, torch.Tensor]:
    if isinstance(plan, UnetPlan):
        from anatomix_tpu_torch.models.convert import from_jax_params

        return trainable_state(plan, from_jax_params(plan, tree))
    from anatomix_tpu_torch.models.vit3d.convert import from_jax_primus_params

    return from_jax_primus_params(plan, tree)


def _jax_mask(tree, frozen_layers=()) -> list[bool]:
    """`_trainable_mask` of the JAX package, per leaf in flatten order."""
    frozen = {str(i) for i in frozen_layers}
    out = []
    for path, _ in tree_items(tree):
        keys = path.split("/")
        out.append(not (any(k in _STATS for k in keys)
                        or (frozen and keys[0] in frozen)))
    return out


def _opt_keys(name: str, tree, mask, grad_accum) -> list:
    paths = [p for p, _ in tree_items(tree)]
    trained = [p for p, m in zip(paths, mask) if m]
    chain = ([(name, "count")] + [(name, "mu", p) for p in trained]
             + [(name, "nu", p) for p in trained]
             + [(name, "schedule_count")])
    if grad_accum > 1:
        return ([(name, "mini_step"), (name, "gradient_step")] + chain
                + [(name, "acc", p) for p in paths])
    return chain


def jax_state_keys(plan, params_g, params_f, *,
                   frozen_layers: Sequence[int] = (),
                   grad_accum: int = 1) -> list:
    """The names of the JAX `TrainState`'s leaves in flatten order, for a
    state of `plan` whose parameters have the structure of the port's
    `params_g` and `params_f`: ("step",), ("params_g", path), ("params_f",
    path), ("opt_state_g", "count" | "mu" | "nu" | "schedule_count" |
    "mini_step" | "gradient_step" | "acc", [path]), the same for
    "opt_state_f", then ("lr_scale",). Global-norm clipping adds no
    leaf (its state is empty), so the clip settings do not enter."""
    jg = _jax_params_g(plan, params_g)
    keys: list = [("step",)]
    keys += [("params_g", p) for p, _ in tree_items(jg)]
    keys += [("params_f", p) for p, _ in tree_items(params_f)]
    keys += _opt_keys("opt_state_g", jg, _jax_mask(jg, frozen_layers),
                      grad_accum)
    keys += _opt_keys("opt_state_f", params_f, _jax_mask(params_f),
                      grad_accum)
    keys.append(("lr_scale",))
    return keys


def _fill(template, values: dict[str, np.ndarray]):
    """`template`'s structure with each leaf at path p replaced by
    `values[p]` (zeros of the leaf's shape where absent)."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(tree[k], f"{prefix}{k}/") for k in tree}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{prefix}[{i}]/") for i, v in enumerate(tree)]
        path = prefix[:-1]
        if path in values:
            return values[path]
        return np.zeros(tuple(tree.shape), np.float32)
    return walk(template, "")


def load_jax_train_state(path: str, plan, like: TrainState, *,
                         frozen_layers: Sequence[int] = (),
                         grad_accum: int = 1,
                         device=None) -> TrainState:
    """The JAX run's `TrainState` in `path` (`leaf_{i}` arrays) as the
    port's, on `like`'s device (or `device`): parameters, AdamW moments
    (zeros at the leaves the optimizer masks, as the port keeps them),
    the update count, the MultiSteps accumulator and mini-step, the step
    and `lr_scale`. `like` is a state of the same plan and settings (the
    trainer's fresh one), whose structure names the leaves. Raises with the
    JAX package's message when the counts differ."""
    with np.load(path, allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    keys = jax_state_keys(plan, like.params_g, like.params_f,
                          frozen_layers=frozen_layers, grad_accum=grad_accum)
    if len(leaves) != len(keys):
        raise ValueError(
            f"Checkpoint has {len(leaves)} leaves; template expects "
            f"{len(keys)} (architecture/optimizer mismatch).")
    by: dict[tuple, dict[str, np.ndarray]] = {}
    scalars: dict[tuple, np.ndarray] = {}
    for key, leaf in zip(keys, leaves):
        if isinstance(key[-1], str) and len(key) >= 2 and key[-2] in (
                "params_g", "params_f", "mu", "nu", "acc"):
            by.setdefault(key[:-1], {})[key[-1]] = leaf
        else:
            scalars[key] = leaf
    dev = device or next(iter(like.params_g.values())).device
    to_dev = lambda t: torch.as_tensor(  # noqa: E731
        np.asarray(t, np.float32)).to(dev)
    jg = _jax_params_g(plan, like.params_g)

    def g_tree(values):
        return tree_map(lambda t: t.to(dev),
                        _from_jax_params_g(plan, _fill(jg, values)))

    def f_tree(values):
        return tree_map(to_dev, _fill(like.params_f, values))

    def opt(name, tree_of):
        state = {"count": int(scalars[(name, "count")]),
                 "mu": tree_of(by.get((name, "mu"), {})),
                 "nu": tree_of(by.get((name, "nu"), {}))}
        if grad_accum > 1:
            state.update(mini_step=int(scalars[(name, "mini_step")]),
                         acc=tree_of(by.get((name, "acc"), {})))
        return state

    return TrainState(
        step=int(scalars[("step",)]),
        params_g=g_tree(by[("params_g",)]),
        params_f=f_tree(by[("params_f",)]),
        opt_state_g=opt("opt_state_g", g_tree),
        opt_state_f=opt("opt_state_f", f_tree),
        lr_scale=float(scalars[("lr_scale",)]),
    )


def is_leaf_file(path: str) -> bool:
    """Whether `path` holds a JAX run's ordered leaves (`leaf_0`, ...)."""
    with np.load(path, allow_pickle=False) as z:
        return "leaf_0" in z.files

