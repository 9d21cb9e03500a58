"""Multi-host entry points: join a process group, each rank's scan block.

Counterpart of ``lidar_slam_arvc_tpu/parallel/multihost.py``.  In the
port every multi-device run is multi-process (one rank per device), so
the reference's two modes, a single-controller mesh and a multi-controller
run with per-host I/O, are one: ``initialize`` joins the group that
``torchrun`` (or the caller) describes, and under ``--shard-scans`` each
rank loads and preprocesses only its own contiguous block of scans.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lidar_slam_arvc_tpu_torch.parallel import mesh as _mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               timeout_s: float = _mesh.DEFAULT_TIMEOUT_S) -> dict:
    """Join the process group (a no-op for one process) and report the
    topology.

    With ``num_processes`` > 1: a TCP rendezvous at ``coordinator_address``
    (``host:port``) as rank ``process_id``.  Without arguments, the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) when it is set.
    The rank runs on ``cuda:{LOCAL_RANK % cards}`` or the CPU; the backend
    is ``mesh.choose_backend``'s, printed."""
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("a group of several processes needs the "
                             "coordinator address and this process's id")
        init, size, rank = f"tcp://{coordinator_address}", num_processes, process_id
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and "MASTER_ADDR" in os.environ:
        init, size, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    else:
        size = 1
    if size > 1 and not torch.distributed.is_initialized():
        dev = _mesh.device_of_rank(device, local_rank)
        backend, why = _mesh.choose_backend(dev, per_host)
        print(f"rank {rank} of {size} on {dev}: backend {backend} ({why})",
              flush=True)
        _mesh.init_rank(backend, init, rank, size, dev, timeout_s)
    dev = _mesh.rank_device()
    return {
        "process_index": _mesh.world_rank(),
        "process_count": _mesh.world_size(),
        "local_devices": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "global_devices": _mesh.world_size(),
    }


def in_torchrun_group() -> bool:
    """Whether the environment describes a group of several processes."""
    return ("RANK" in os.environ and "MASTER_ADDR" in os.environ
            and int(os.environ.get("WORLD_SIZE", "1")) > 1)


def assemble_global_scans(mesh: _mesh.DataMesh, local_arrays: dict,
                          n_total: int, axis: str = "data") -> dict:
    """This rank's loaded scan block, checked and placed on its device.

    The reference assembles the per-host blocks into one globally sharded
    array; torch has no global array, so each rank keeps its own block of
    ``n_total / size`` rows (``n_total`` a multiple of the mesh size,
    padded with copies of the last scan) and the callers exchange rows
    through ``mesh.gather_rows``.  ``local_arrays`` maps a name to an
    (n_local, ...) array or tensor."""
    if n_total % mesh.size:
        raise ValueError(f"{n_total} scans do not divide over {mesh.size} ranks")
    k = n_total // mesh.size
    out = {}
    for name, a in local_arrays.items():
        if a.shape[0] != k:
            raise ValueError(f"{name}: {a.shape[0]} rows on rank {mesh.rank}, "
                             f"expected {n_total} / {mesh.size} = {k}")
        out[name] = torch.as_tensor(a, device=mesh.device)
    return out


def host_scan_shard(n_scans: int, process_index: int | None = None,
                    process_count: int | None = None) -> np.ndarray:
    """Scan indices this host is responsible for loading/preprocessing.

    Contiguous blocks keep consecutive-pair ICP local to one host except at
    shard boundaries (boundary scans are loaded by both neighbors)."""
    pi = _mesh.world_rank() if process_index is None else process_index
    pc = _mesh.world_size() if process_count is None else process_count
    bounds = np.linspace(0, n_scans, pc + 1).astype(int)
    lo, hi = bounds[pi], bounds[pi + 1]
    # include one overlap scan on the left so pair (lo-1, lo) is computable
    lo_ext = max(lo - 1, 0)
    return np.arange(lo_ext, hi)
