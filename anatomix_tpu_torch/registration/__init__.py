"""Training-free multimodal registration, ConvexAdam on anatomix features
(the port of `anatomix_tpu.registration`, with the same public names)."""

from anatomix_tpu_torch.extract import extract_features
from anatomix_tpu_torch.models.load import load_model
from anatomix_tpu_torch.ops.pool import box_filter as apply_avg_pool3d
from anatomix_tpu_torch.registration.correlate import (
    COUPLED_COEFFS,
    correlate,
    coupled_convex,
    displacement_mesh,
)
from anatomix_tpu_torch.registration.merge import merge_features
from anatomix_tpu_torch.registration.mind import mindssc as MINDSSC
from anatomix_tpu_torch.registration.mind import mindssc, pdist_squared
from anatomix_tpu_torch.registration.pipeline import (
    convex_adam,
    macro_dice,
    register_pair,
)
from anatomix_tpu_torch.registration.solver import (
    run_instance_opt,
    run_stage1_registration,
)
from anatomix_tpu_torch.registration.warp import (
    diffusion_regularizer,
    generate_grid,
    inverse_consistency,
    jacobian_det,
    normalize_disp,
    smooth_disp,
    warp_volume,
)

__all__ = [
    "COUPLED_COEFFS",
    "MINDSSC",
    "apply_avg_pool3d",
    "convex_adam",
    "correlate",
    "coupled_convex",
    "diffusion_regularizer",
    "displacement_mesh",
    "extract_features",
    "generate_grid",
    "inverse_consistency",
    "jacobian_det",
    "load_model",
    "macro_dice",
    "merge_features",
    "mindssc",
    "normalize_disp",
    "pdist_squared",
    "register_pair",
    "run_instance_opt",
    "run_stage1_registration",
    "smooth_disp",
    "warp_volume",
]
