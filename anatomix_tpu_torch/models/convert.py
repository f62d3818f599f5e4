"""Weight carry-over between the JAX package's pytree, the port's state
dict and the reference `.pth`.

The port's state dict is the reference's: flat-Sequential keys
`model.<idx>.weight` / `.bias` / `.running_mean` / `.running_var` /
`.num_batches_tracked`, convs in (O, I, kD, kH, kW). The JAX pytree is keyed
by the same index as a string, with DHWIO convs `{"w", "b"}`, batch norms
`{"scale", "bias", "mean", "var"}` and `instance_affine` norms
`{"scale", "bias"}` (state dict `weight` / `bias`). Plain instance norms have
no parameters.

`from_jax_train_state` carries a JAX pretraining `TrainState` across, of
the UNet or of the Primus ViT.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from anatomix_tpu_torch.models.unet import UnetPlan

_PREFIXES = ("_orig_mod.", "module.")


def strip_prefixes(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Strip `_orig_mod.` (torch.compile) / `module.` (DataParallel)
    wrappers, possibly stacked."""
    out = {}
    for key, val in state_dict.items():
        changed = True
        while changed:
            changed = False
            for pre in _PREFIXES:
                if key.startswith(pre):
                    key = key[len(pre):]
                    changed = True
        out[key] = val
    return out


def _t(val) -> torch.Tensor:
    return torch.from_numpy(np.array(val, dtype=np.float32))


def from_jax_params(
    plan: UnetPlan, params: Mapping[str, Mapping[str, Any]]
) -> dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) -> the port's state dict (CPU float32)."""
    sd: dict[str, torch.Tensor] = {}
    for idx, spec in enumerate(plan.layers):
        p = params.get(str(idx))
        base = f"model.{idx}"
        if spec.kind == "conv":
            w = np.asarray(p["w"], np.float32)
            sd[f"{base}.weight"] = _t(np.transpose(w, (4, 3, 0, 1, 2)))
            if "b" in p:
                sd[f"{base}.bias"] = _t(p["b"])
        elif spec.kind == "norm" and plan.config.norm == "batch":
            sd[f"{base}.weight"] = _t(p["scale"])
            sd[f"{base}.bias"] = _t(p["bias"])
            sd[f"{base}.running_mean"] = _t(p["mean"])
            sd[f"{base}.running_var"] = _t(p["var"])
            sd[f"{base}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long
            )
        elif spec.kind == "norm" and plan.config.norm == "instance_affine":
            sd[f"{base}.weight"] = _t(p["scale"])
            sd[f"{base}.bias"] = _t(p["bias"])
    return sd


def to_jax_params(
    plan: UnetPlan, state_dict: Mapping[str, torch.Tensor]
) -> dict[str, dict[str, np.ndarray]]:
    """The port's state dict -> JAX pytree with numpy leaves."""
    sd = strip_prefixes(state_dict)
    params: dict[str, dict[str, np.ndarray]] = {}

    def arr(key):
        return sd[key].detach().cpu().float().numpy()

    for idx, spec in enumerate(plan.layers):
        base = f"model.{idx}"
        if spec.kind == "conv":
            p = {"w": np.ascontiguousarray(
                np.transpose(arr(f"{base}.weight"), (2, 3, 4, 1, 0))
            )}
            if f"{base}.bias" in sd:
                p["b"] = arr(f"{base}.bias")
            params[str(idx)] = p
        elif spec.kind == "norm" and plan.config.norm == "batch":
            params[str(idx)] = {
                "scale": arr(f"{base}.weight"),
                "bias": arr(f"{base}.bias"),
                "mean": arr(f"{base}.running_mean"),
                "var": arr(f"{base}.running_var"),
            }
        elif spec.kind == "norm" and plan.config.norm == "instance_affine":
            params[str(idx)] = {
                "scale": arr(f"{base}.weight"),
                "bias": arr(f"{base}.bias"),
            }
    return params


def check_state_dict(plan: UnetPlan, state_dict: Mapping[str, Any]) -> None:
    """Raise if the state dict misses a parameter of the plan or holds keys
    the plan does not consume (an architecture mismatch)."""
    wanted = set()
    for idx, spec in enumerate(plan.layers):
        base = f"model.{idx}"
        if spec.kind == "conv":
            wanted.add(f"{base}.weight")
        elif spec.kind == "norm" and plan.config.norm == "batch":
            wanted |= {f"{base}.{n}" for n in
                       ("weight", "bias", "running_mean", "running_var")}
        elif spec.kind == "norm" and plan.config.norm == "instance_affine":
            wanted |= {f"{base}.weight", f"{base}.bias"}
    optional = {f"model.{i}.bias" for i in plan.conv_indices}
    keys = {k for k in state_dict if not k.endswith("num_batches_tracked")}
    missing = wanted - keys
    extra = keys - wanted - optional
    if missing or extra:
        raise ValueError(
            "state dict does not match the plan (architecture mismatch?): "
            f"missing {sorted(missing)[:8]}, unconsumed {sorted(extra)[:8]}"
        )


def load_pth(path: str, plan: UnetPlan) -> dict[str, torch.Tensor]:
    """Load a reference `.pth` checkpoint as the port's state dict (CPU,
    float32), prefixes stripped and keys checked against `plan`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path} does not hold a state dict")
    sd = strip_prefixes(sd)
    check_state_dict(plan, sd)
    return {
        k: (v.float() if v.is_floating_point() else v) for k, v in sd.items()
    }


def from_jax_train_state(state_np: Mapping[str, Any], plan, *,
                         grad_accum: int = 1):
    """A JAX pretraining `TrainState` given as nested numpy arrays (keys
    `step`, `params_g`, `params_f`, optionally `lr_scale`) -> the port's
    `TrainState` (CPU, float32). `params_g` goes through `from_jax_params`
    (`plan` a `UnetPlan`) or `vit3d.convert.from_jax_primus_params` (`plan`
    a `PrimusConfig`);
    `params_f` (`mlp_<t>`: `linears` (in, out), `bns` {mean, var[, scale,
    bias]}) keeps its structure. The optimizer states start fresh (zero
    moments, count 0), as a JAX state from `init_train_state` does."""
    from anatomix_tpu_torch.pretraining.train_step import (
        TrainState,
        init_opt_state,
        tree_map,
    )

    if isinstance(plan, UnetPlan):
        params_g = {k: v for k, v in
                    from_jax_params(plan, state_np["params_g"]).items()
                    if v.is_floating_point()}
    else:
        from anatomix_tpu_torch.models.vit3d.convert import (
            from_jax_primus_params,
        )

        params_g = from_jax_primus_params(plan, state_np["params_g"])
    params_f = tree_map(_t, dict(state_np["params_f"]))
    return TrainState(
        step=int(np.asarray(state_np["step"])),
        params_g=params_g, params_f=params_f,
        opt_state_g=init_opt_state(params_g, grad_accum),
        opt_state_f=init_opt_state(params_f, grad_accum),
        lr_scale=float(np.asarray(state_np.get("lr_scale", 1.0))),
    )
