"""Parallelism on `torch.distributed`: meshes of ranks, data parallelism,
window-sharded sliding and the spatially sharded (halo-exchange) forward.

The port of `anatomix_tpu/parallel/`. PyTorch runs one process per device
(`launch.spawn` on one host, `torchrun` across hosts), NCCL between cards
and gloo on the CPU; a `Mesh` is this rank's place on the grid of ranks
with its process group along each axis. The paths that take a mesh:
`pretraining/train_step.build_train_step(..., mesh=)` and
`pretraining/train.train` (data parallelism), `ops/sliding_window.
sliding_window_inference(..., mesh=)` and `extract.make_feature_extractor(
..., mesh=)` (window-sharded sliding; 'full' with a 'space' axis goes to
`extract.spatial_sharded_unet`, which runs `models/unet_sharded.py` on
the halo exchange of `spatial`). `dryrun` runs every mode on N ranks.
"""

from anatomix_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    data_mesh,
    group_mean,
    replicate,
    shard_batch,
    space_mesh,
)
from anatomix_tpu_torch.parallel.multihost import (
    fold_in_process,
    global_batch_from_local,
    global_data_mesh,
    initialize_distributed,
)
from anatomix_tpu_torch.parallel.spatial import (
    gather_d,
    halo_pad_d,
    receptive_field,
)

__all__ = [
    "Mesh",
    "all_reduce_sum",
    "data_mesh",
    "fold_in_process",
    "gather_d",
    "global_batch_from_local",
    "global_data_mesh",
    "group_mean",
    "halo_pad_d",
    "initialize_distributed",
    "receptive_field",
    "replicate",
    "shard_batch",
    "space_mesh",
]
