"""Starting the multi-process map: one process per GPU (or per CPU worker).

``initialize_multihost`` joins this process to the process group from the
coordinator's address, the number of processes and this process's id, or
from the environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) when they are not given, and
returns the process ``Grid`` that ``parallel.sharding`` tiles the map over.
Nothing tells a program of a cluster: the caller gives the address.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from traversability_estimation_tpu_torch.device import DeviceLike, resolve_device
from traversability_estimation_tpu_torch.parallel.sharding import Grid, backend_for, make_grid


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
) -> Grid:
    """Join the process group and return the grid over it.

    `coordinator_address` ("host:port" of process 0), `num_processes` and
    `process_id` default to ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK`` of the environment. The backend is ``nccl`` on CUDA (this
    process takes the GPU ``LOCAL_RANK``, else its id modulo the host's GPU
    count) and ``gloo`` when the caller asks for the CPU. A group that is
    already up is kept. Raises when the group's size differs from
    `num_processes`.
    """
    dev = resolve_device(device)
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if not dist.is_initialized():
        if coordinator_address is None:
            if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
                raise ValueError(
                    "initialize_multihost: give coordinator_address or set MASTER_ADDR and MASTER_PORT")
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if process_id is None:
            process_id = int(env.get("RANK", 0))
        if num_processes is None:
            num_processes = 1
        if dev.type == "cuda":
            local = env.get("LOCAL_RANK")
            torch.cuda.set_device(int(local) if local is not None
                                  else process_id % torch.cuda.device_count())
        dist.init_process_group(
            backend_for(dev), init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
        )
    if num_processes is not None and dist.get_world_size() != num_processes:
        raise RuntimeError(
            f"initialize_multihost: expected {num_processes} processes, the group has "
            f"{dist.get_world_size()}"
        )
    return make_grid(dev)
