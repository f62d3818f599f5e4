"""3D ViT (Primus v2): the port of `anatomix_tpu/models/vit3d/`."""

from anatomix_tpu_torch.models.vit3d.primus import (
    PRIMUS_CONFIGS,
    Primus,
    PrimusConfig,
    build_out_norm,
    init_primus_params,
    primus_apply,
    primus_config,
    primus_param_count,
)
from anatomix_tpu_torch.models.vit3d.convert import (  # noqa: E402
    convert_primus_state_dict,
    from_jax_primus_params,
    load_primus_state_dict,
)
from anatomix_tpu_torch.models.vit3d.primus_train import (  # noqa: E402
    primus_train_apply,
)

__all__ = [
    "PRIMUS_CONFIGS",
    "Primus",
    "PrimusConfig",
    "build_out_norm",
    "convert_primus_state_dict",
    "from_jax_primus_params",
    "init_primus_params",
    "load_primus_state_dict",
    "primus_apply",
    "primus_config",
    "primus_param_count",
    "primus_train_apply",
]
