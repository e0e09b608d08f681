"""The devices of a run and the process topology, ported from
stringdecomposer_tpu/parallel/mesh.py.

Windows are the data-parallel axis: the reference's OpenMP `parallel for`
over read chunks (src/main.cpp:86-102) becomes a list of devices that each
run the same kernels on their shard of the batch; the monomer tensor (KBs)
is copied to every device; results come back in shard order to the
caller's device, so no collective rides the output path and the bytes do
not depend on the device count.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch

# heavily loaded hosts can take minutes to reach the rendezvous (cold
# imports, kernel builds): the same 600 s the JAX package gives
# jax.distributed as its initialization_timeout
INIT_TIMEOUT_S = 600


def get_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """Every visible GPU for "cuda" (one, for "cuda:N"), or the CPU for
    "cpu". Asking for CUDA without a card raises: a run never carries on on
    the CPU unless told to."""
    from ..pipeline import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Multi-host bring-up through torch.distributed (gloo: the group only
    gives the processes their topology; reads are sharded per host by the
    caller, parallel/multihost.shard_indices, and no tensor crosses hosts).
    `coordinator` is host:port, where process 0 listens; without it the
    rendezvous comes from the environment (MASTER_ADDR, MASTER_PORT).
    `num_processes` and `process_id` default to WORLD_SIZE and RANK."""
    import torch.distributed as dist

    def env_int(name: str) -> int:
        try:
            return int(os.environ[name])
        except (KeyError, ValueError) as e:
            raise ValueError(f"{name} must be set to an integer when its flag is not given") from e

    world = num_processes if num_processes is not None else env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else env_int("RANK")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=world, rank=rank, timeout=timedelta(seconds=INIT_TIMEOUT_S),
    )


def shutdown_distributed() -> None:
    """Leave the process group, if one is up (idempotent)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
