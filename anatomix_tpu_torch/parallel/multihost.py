"""Multi-process (multi-host) start-up of the port's data parallelism.

The port of `anatomix_tpu/parallel/multihost.py:35-110`. Under `torchrun`
(or any launcher that sets the same variables) each process drives one
card; `initialize_distributed` joins them into one process group (NCCL on
the cards, gloo on the CPU), `global_data_mesh` is the 'data' mesh over
every rank, each rank feeds its contiguous shard of the global batch
(`global_batch_from_local`), and `fold_in_process` gives each rank a seed
of its own.

    torchrun --nproc_per_node N -m anatomix_tpu_torch.pretraining.train \\
        --multihost true ...

Variables read, torchrun's first: `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`; else JAX's `JAX_COORDINATOR_ADDRESS`
(host:port), `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`. Nothing set, or a
world of one, is the single-process run: no group is made and the call
returns False, as the JAX package's does.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from anatomix_tpu_torch.parallel.mesh import Mesh, data_mesh, tensor_leaves

# how long a collective may wait for a rank before the run fails
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(*names):
    for n in names:
        v = os.environ.get(n)
        if v:
            return int(v)
    return None


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | torch.device = "cuda",
) -> bool:
    """Join the process group of a multi-process run; True if one was
    initialized, False for the single-process run. `device` "cuda" uses
    NCCL and binds this process to card `LOCAL_RANK` (else its rank
    modulo the cards it sees); "cpu" uses gloo. Raises if the group cannot
    be formed. A process group that already exists is taken as it is."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        coordinator_address = (f"{addr}:{port}" if addr and port
                               else os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    if not num_processes or num_processes == 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"a world of {num_processes} needs a coordinator address and "
            "this process's rank (MASTER_ADDR/MASTER_PORT and RANK, or "
            "JAX_COORDINATOR_ADDRESS and JAX_PROCESS_ID)")
    dev = torch.device(device)
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("device='cuda' but no card is visible")
        torch.cuda.set_device(local if local is not None
                              else process_id % n_cards)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=COLLECTIVE_TIMEOUT)
    return dist.get_world_size() > 1


def global_data_mesh(*, device: str | torch.device = "cuda") -> Mesh:
    """1-D 'data' mesh over every rank of the world, in rank order (ranks
    of one host are adjacent under torchrun, so NCCL keeps the host's part
    of the gradient all-reduce on NVLink)."""
    return data_mesh(device=device)


def global_batch_from_local(mesh: Mesh, local_tree):
    """This rank's contiguous shard of the global batch, as tensors on the
    mesh's device: each leaf of `local_tree` (numpy or tensors, dicts and
    lists) moved there. Every rank must hold the same number of rows; the
    global batch is `mesh.size` times that. Raises if the ranks differ."""
    def one(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x).to(mesh.device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return one(tree)

    out = walk(local_tree)
    rows = {int(t.shape[0]) for t in tensor_leaves(out)}
    if len(rows) > 1:
        raise ValueError(f"local leaves disagree on their rows: {rows}")
    n = torch.tensor([rows.pop() if rows else 0] * 2, dtype=torch.int64,
                     device=mesh.device)
    n[1] = -n[1]
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    if int(n[0]) != -int(n[1]):
        raise ValueError(f"ranks hold {-int(n[1])} to {int(n[0])} rows; the "
                         "global batch must divide evenly")
    return out


def fold_in_process(seed: int) -> int:
    """A 31-bit seed for this rank's own generators, from `seed` and the
    rank (0 when single-process): augmentations that must differ across
    the ranks' shards draw from it."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0]
               & 0x7FFFFFFF)
