"""Checkpoints of the pretraining state as flat `.npz` files of numpy
leaves (the port of `anatomix_tpu/utils/checkpoint.py`'s `.npz` format).

A tree of dicts, lists and tensors flattens to `path/to/leaf` keys; lists
carry a `__len__` entry, as in the JAX package's `save_pytree`, so
`load_pytree` reads the JAX package's files as well, including a list of
arrays, which the JAX package's own reader cannot read back.

The trainer's resumable state (`latest_train_state.npz`) is the named-key
tree of `save_train_state`. `load_train_state` also reads the JAX
package's ordered leaves (`save_state_leaves`, `leaf_{i}`), given the
trainer's fresh state to name them (`pretraining/jax_state.py`).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from anatomix_tpu_torch.device import resolve_device


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__len__"] = np.asarray(
            [len(tree), 1 if isinstance(tree, tuple) else 0])
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]/"))
    elif tree is None:
        out[f"{prefix}__none__"] = np.asarray(0)
    elif torch.is_tensor(tree):
        out[prefix.rstrip("/")] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    if list(flat) == [""]:
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
        items = [_unflatten(groups[f"[{i}]"]) if f"[{i}]" in groups
                 else scalars[f"[{i}]"] for i in range(n)]
        return tuple(items) if meta is not None and meta[1] else items
    if "__none__" in scalars:
        return None
    out: dict[str, Any] = dict(scalars)
    for k, sub in groups.items():
        out[k] = _unflatten(sub)
    return out


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors / arrays (dicts, lists, None) to `.npz`."""
    np.savez(path, **_flatten(tree))


def load_pytree(path: str) -> Any:
    """The tree `save_pytree` wrote, with numpy leaves."""
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def _to_tensors(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def save_train_state(path: str, state) -> None:
    """Save a `pretraining.train_step.TrainState`: parameters, optimizer
    states, step and learning-rate scale."""
    save_pytree(path, {
        "step": state.step, "lr_scale": state.lr_scale,
        "params_g": state.params_g, "params_f": state.params_f,
        "opt_state_g": state.opt_state_g, "opt_state_f": state.opt_state_f,
    })


def load_train_state(path: str, device: str | torch.device = "cuda", *,
                     jax_layout: dict | None = None):
    """The `TrainState` `save_train_state` wrote, its tensors on `device`
    (the card unless the caller asks for the CPU; raises without one); or
    a JAX run's ordered leaves, which `jax_layout` names: the keyword
    arguments of `pretraining.jax_state.load_jax_train_state` (`plan`,
    `like` the trainer's fresh state, `frozen_layers`, `grad_accum`)."""
    from anatomix_tpu_torch.pretraining import jax_state
    from anatomix_tpu_torch.pretraining.train_step import TrainState

    device = resolve_device(device)
    if jax_state.is_leaf_file(path):
        if jax_layout is None:
            raise ValueError(f"{path} holds a JAX run's ordered leaves: "
                             "pass jax_layout to name them")
        return jax_state.load_jax_train_state(path, device=device,
                                              **jax_layout)
    tree = load_pytree(path)

    def opt(s):
        s = dict(s)
        out = {k: _to_tensors(v, device) for k, v in s.items()
               if k in ("mu", "nu", "acc")}
        out.update({k: int(v) for k, v in s.items()
                    if k in ("count", "mini_step")})
        return out

    return TrainState(
        step=int(tree["step"]), lr_scale=float(tree["lr_scale"]),
        params_g=_to_tensors(tree["params_g"], device),
        params_f=_to_tensors(tree["params_f"], device),
        opt_state_g=opt(tree["opt_state_g"]),
        opt_state_f=opt(tree["opt_state_f"]),
    )


def save_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=str)


def latest_checkpoint(ckpt_dir: str, prefix: str = "epoch") -> str | None:
    """The last `<prefix>*.npz` of `ckpt_dir` in name order, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith(prefix) and f.endswith(".npz")]
    if not cands:
        return None
    return os.path.join(ckpt_dir, sorted(cands)[-1])
