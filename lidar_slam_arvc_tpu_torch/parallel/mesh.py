"""Ranks, the data mesh, and the exact collectives of the multi-device paths.

Counterpart of ``lidar_slam_arvc_tpu/parallel/mesh.py``.  JAX runs one
controller over a ``Mesh`` of devices; the port runs one process (rank)
per device, the same program in every rank (``torch.distributed``), so a
mesh of N devices is a process group of N ranks.  ``DataMesh`` names that
group with this rank's index and device; ``resolve_mesh`` keeps the
reference's rules for ``IcpConfig.mesh_devices``.

Rank r runs on ``cuda:{r % cards}`` (or the CPU).  The backend is NCCL
when every rank has a card of its own and gloo when ranks share a card or
run on the CPU (NCCL refuses two ranks on one card).  Under gloo a CUDA
tensor may go through ``all_reduce`` and ``broadcast`` only, so every
exchange here is written on those two, and each is exact on every
backend: a row gather writes each rank's rows into a zero buffer and sums
it over the ranks as integers of the same width (x + 0 keeps every bit,
-0.0 and NaN included); the halo exchange is the gather of one row.
``collective_counts`` counts the calls and bytes of each kind, as
``ops._cuda.launch_counts`` counts kernel launches.

``launch(n, fn, *args)`` spawns n ranks (the *spawn* start method: the
ranks use CUDA), which meet through a ``FileStore`` in a temporary
directory (no TCP port), run ``fn(*args)`` and hand back its results; an
exception or a hang past the group's timeout in any rank makes it raise.
Importing this module starts no process and initialises no group.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

# seconds a rank waits in a collective (and at the rendezvous) before the
# group fails the run instead of hanging it
DEFAULT_TIMEOUT_S = 300.0
# seconds the other ranks get to finish once one rank has failed
FAILURE_GRACE_S = 10.0

# calls and bytes of each kind of exchange since the last reset
collective_counts = {k: {"calls": 0, "bytes": 0}
                     for k in ("reduce", "gather", "halo", "broadcast", "barrier")}

# the device of this process's rank, set when the group is initialised
_rank = {"device": None}


def counts_since(before: dict) -> dict:
    """The calls and bytes of each kind since the snapshot ``before``
    (a deep copy of ``collective_counts``)."""
    return {k: {f: v[f] - before[k][f] for f in v}
            for k, v in collective_counts.items()}


class DataMesh(NamedTuple):
    """A process group used as a 1-D data mesh: ``size`` ranks, this one
    ``rank``, on ``device`` (``group`` None: the default group, or a
    single process without one)."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str | None

    @property
    def shape(self) -> dict:
        return {"data": self.size}


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device() -> torch.device:
    """This rank's device: the one its group was initialised for, else
    the current card or the CPU."""
    if _rank["device"] is not None:
        return _rank["device"]
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_mesh(n_devices: int | None = None, axis: str = "data") -> DataMesh:
    """The mesh of every rank of the group (of this process alone when no
    group is initialised).  ``n_devices`` must be the group's size: a
    rank cannot be left out of a mesh that its program runs."""
    if axis != "data":
        raise ValueError(f"the port's mesh has one axis, 'data', not {axis!r}")
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} "
                         f"ranks; the process group has {n}")
    return DataMesh(None, world_rank(), n, rank_device(),
                    dist.get_backend() if dist.is_initialized() else None)


def resolve_mesh(mesh_devices: int, axis: str = "data") -> DataMesh | None:
    """IcpConfig.mesh_devices -> DataMesh (None = run on one device).

    1 -> None; 0 -> every rank of the group (None if there is one); N > 1
    -> a mesh of exactly N ranks (ValueError naming both counts when the
    group has another number)."""
    if mesh_devices == 1:
        return None
    avail = world_size()
    n = avail if mesh_devices == 0 else mesh_devices
    if n != avail:
        raise ValueError(f"mesh_devices={mesh_devices} but the process group "
                         f"has {avail} rank(s); launch {n} ranks "
                         "(pipeline.cli --devices N, or torchrun)")
    return data_mesh(n, axis) if n > 1 else None


def shard_bounds(n: int, mesh: DataMesh) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous block of n rows (n divisible by
    the mesh size)."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks")
    k = n // mesh.size
    return mesh.rank * k, (mesh.rank + 1) * k


def shard_batch(mesh: DataMesh, *arrays, axis: str = "data"):
    """This rank's contiguous block of each array's leading (batch) axis
    (the counterpart of placing it sharded over the mesh)."""
    out = []
    for a in arrays:
        lo, hi = shard_bounds(a.shape[0], mesh)
        out.append(a[lo:hi])
    return tuple(out)


# ------------------------------------------------------------ collectives

_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _count(kind: str, t: torch.Tensor) -> None:
    collective_counts[kind]["calls"] += 1
    collective_counts[kind]["bytes"] += t.numel() * t.element_size()


def all_reduce_sum(mesh: DataMesh, t: torch.Tensor, kind: str = "reduce") -> torch.Tensor:
    """Sum of ``t`` over the ranks, in place (every rank gets the same
    bits); a no-op on a one-rank mesh."""
    if mesh.size > 1:
        _count(kind, t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def broadcast(mesh: DataMesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` in every rank, in place."""
    if mesh.size > 1:
        _count("broadcast", t)
        dist.broadcast(t, src=src, group=mesh.group)
    return t


def barrier(mesh: DataMesh) -> None:
    """Every rank waits for the others (a one-element all_reduce, which
    every backend takes on every device)."""
    if mesh.size > 1:
        t = torch.zeros(1, device=mesh.device)
        _count("barrier", t)
        dist.all_reduce(t, group=mesh.group)


def gather_rows(mesh: DataMesh, local: torch.Tensor, n_total: int, offset: int,
                kind: str = "gather") -> torch.Tensor:
    """(n_total, ...) in every rank: each rank's ``local`` rows at its own
    ``offset``, the rest of the buffer zero, summed over the ranks as
    integers of the element's width, so the result is bit-equal to the
    concatenation of the blocks."""
    if mesh.size == 1 and offset == 0 and local.shape[0] == n_total:
        return local
    local = local.to(mesh.device)
    buf = local.new_zeros((n_total,) + tuple(local.shape[1:]))
    buf[offset:offset + local.shape[0]] = local
    return merge_exact(mesh, buf, kind)


def merge_exact(mesh: DataMesh, buf: torch.Tensor, kind: str = "gather") -> torch.Tensor:
    """The sum over the ranks of ``buf``, in which each rank wrote its own
    entries and left the others zero, taken over integers of the
    element's width: every written entry arrives bit for bit."""
    if mesh.size > 1:
        all_reduce_sum(mesh, buf.view(_INT_OF_WIDTH[buf.element_size()]), kind)
    return buf


def gather_blocks(mesh: DataMesh, *locals_: torch.Tensor):
    """Each tensor's equal per-rank blocks gathered in rank order into
    the whole (the inverse of ``shard_batch``)."""
    return tuple(gather_rows(mesh, t, t.shape[0] * mesh.size,
                             t.shape[0] * mesh.rank) for t in locals_)


def halo_next(mesh: DataMesh, row: torch.Tensor) -> torch.Tensor:
    """The next rank's ``row`` (cyclic: the last rank gets rank 0's), by
    a gather of every rank's one row."""
    rows = gather_rows(mesh, row[None], mesh.size, mesh.rank, kind="halo")
    return rows[(mesh.rank + 1) % mesh.size]


def write_once(mesh: DataMesh, write) -> list:
    """Rank 0 runs ``write()``, which returns the paths it wrote; then
    every rank waits for it at a barrier.  An error of the writer is
    raised after the barrier, so the other ranks are not left waiting
    there.  Returns the paths this rank wrote."""
    written, error = [], None
    if mesh.rank == 0:
        try:
            written = write()
        except Exception as exc:     # re-raised below, after the barrier
            error = exc
    barrier(mesh)
    if error is not None:
        raise error
    return written


# ---------------------------------------------------------------- ranks

def choose_backend(device: torch.device, ranks_per_host: int) -> tuple[str, str]:
    """(backend, reason): NCCL when every rank of a host has a card of
    its own, gloo when ranks share a card or run on the CPU."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if ranks_per_host <= cards:
        return "nccl", f"{ranks_per_host} ranks on {cards} cards, one each"
    return "gloo", (f"{ranks_per_host} ranks share {cards} card(s); NCCL "
                    "refuses two ranks on one card")


def device_of_rank(device, local_rank: int) -> torch.device:
    """Rank ``local_rank``'s device: ``cuda:{local_rank % cards}`` for a
    CUDA request, which needs a card (never a silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("rank device 'cuda' requested but no CUDA device "
                           "is available")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_rank(backend: str, init_method: str, rank: int, size: int,
              device: torch.device, timeout_s: float) -> None:
    """Join the group as ``rank`` of ``size`` on ``device``."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _rank["device"] = device


def close_rank() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank["device"] = None


def _rank_entry(rank: int, size: int, tmp: str, device: str, backend: str,
                timeout_s: float, fn, args, log_dir: str | None) -> None:
    if log_dir is not None:
        with open(os.path.join(log_dir, f"rank_{rank}.log"), "ab") as f:
            os.dup2(f.fileno(), 1)
            os.dup2(f.fileno(), 2)
    try:
        dev = device_of_rank(device, rank)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        init_rank(backend, f"file://{tmp}/store", rank, size, dev, timeout_s)
        try:
            out = fn(*args)
        finally:
            close_rank()
        with open(f"{tmp}/result_{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(f"{tmp}/error_{rank}.txt", "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)


class RankError(RuntimeError):
    """A launch in which a rank failed: ``errors`` maps each failed rank
    to its traceback (or its exit code)."""

    def __init__(self, errors: dict):
        self.errors = errors
        super().__init__("rank(s) failed:\n" + "\n".join(
            f"--- rank {r} ---\n{e}" for r, e in sorted(errors.items())))


def launch(n: int, fn, *args, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
           log_dir: str | None = None) -> list:
    """Run ``fn(*args)`` in n new ranks of one group on ``device`` and
    return their results in rank order.  ``fn`` must be importable (the
    ranks are spawned, not forked).  Raises ``RankError`` when a rank
    raises, exits, or waits in a collective past ``timeout_s``; the other
    ranks are stopped after FAILURE_GRACE_S.  ``log_dir``: rank r writes
    its output to ``rank_{r}.log`` there instead of this process's."""
    import multiprocessing
    dev = torch.device(device)
    if dev.type == "cuda":
        device_of_rank(dev, 0)          # no card: raise here, not in n ranks
    backend, why = choose_backend(dev, n)
    print(f"launching {n} ranks on {dev.type}: backend {backend} ({why})",
          flush=True)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs = [ctx.Process(target=_rank_entry,
                             args=(r, n, tmp, str(dev), backend, timeout_s, fn,
                                   args, log_dir))
                 for r in range(n)]
        for p in procs:
            p.start()
        failed_at = None
        try:
            while any(p.is_alive() for p in procs):
                if failed_at is None and any(p.exitcode not in (None, 0) for p in procs):
                    failed_at = time.monotonic()
                if failed_at is not None and time.monotonic() - failed_at > FAILURE_GRACE_S:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = {}
        for r, p in enumerate(procs):
            path = f"{tmp}/error_{r}.txt"
            if os.path.exists(path):
                with open(path) as f:
                    errors[r] = f.read()
            elif p.exitcode != 0:
                errors[r] = f"exit code {p.exitcode}"
        if errors:
            raise RankError(errors)
        out = []
        for r in range(n):
            with open(f"{tmp}/result_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
