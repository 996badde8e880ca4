"""Process start-up and data parallelism over ``torch.distributed``.

Counterpart of ``sparsefusion_tpu/parallel/mesh.py``.  The JAX package
replicates parameters over a device mesh and lets XLA insert the gradient
all-reduce; here each process drives one device, and the train step wraps
its modules in ``DistributedDataParallel`` (``train/trainer.py``).  The
same environment variables start the processes:

    SF_COORDINATOR=<host:port>   SF_NUM_PROCESSES=<n>   SF_PROCESS_ID=<rank>

or ``SF_DISTRIBUTED=1`` with torch's own ``env://`` variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""
from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

from sparsefusion_tpu_torch.utils.image import split_list


def shard_scene_list(scene_indices, n_shards: int, shard_id: int):
    """Scene-level data parallelism (the reference's ``split_list(val_list,
    gpus)[gpu]``)."""
    return split_list(list(scene_indices), n_shards)[shard_id]


def maybe_init_distributed(device_type: str = "cuda",
                           verbose: bool = True) -> bool:
    """Start ``torch.distributed`` from the environment (NCCL for CUDA
    devices, gloo for the CPU); True if it started, False without the
    variables."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    coord = os.environ.get("SF_COORDINATOR")
    if coord:
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}",
            world_size=int(os.environ["SF_NUM_PROCESSES"]),
            rank=int(os.environ["SF_PROCESS_ID"]))
    elif os.environ.get("SF_DISTRIBUTED"):
        dist.init_process_group(backend, init_method="env://")
    else:
        return False
    if verbose:
        print(f"torch.distributed ({backend}): process {dist.get_rank()} / "
              f"{dist.get_world_size()}")
    return True


def rank_and_world() -> Tuple[int, int]:
    """(this process's rank, number of processes); (0, 1) without
    ``torch.distributed``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_device(device: torch.device) -> torch.device:
    """The device of this process: on CUDA without an index, the card of
    the process's rank among the host's cards."""
    if device.type == "cuda" and device.index is None:
        rank, world = rank_and_world()
        if world > 1:
            return torch.device("cuda", rank % torch.cuda.device_count())
    return device
