"""Multi-process start-up on ``torch.distributed`` (JAX
``parallel/multihost.py``).

One process per card: every process calls :func:`initialize` before it
builds a trainer, and the same program then runs on every rank, the
layouts of :mod:`.sharded` and :mod:`.popmesh` splitting the work over the
process group.  The coordinator (``host:port``) holds a ``TCPStore`` that
the processes meet at; rank 0 serves it.  On the card the group's backend
is NCCL and each process takes the card ``process_id % device_count``
(or ``local_device_ids[0]``); on the CPU, and only when the caller asks
for it (``device="cpu"``), it is gloo.

Mesh layout guidance, as in the JAX package: keep the ``model`` axis within
a host and let the ``clients`` axis span hosts, since client shards only
meet at the aggregation's one [d]-sized reduction per step.

Usage (one call per process)::

    from byzantine_aircomp_tpu_torch.parallel import multihost
    multihost.initialize(coordinator="host0:8476", num_processes=4,
                         process_id=rank)

or, with no arguments, the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK`` environment a launcher such as ``torchrun`` sets.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from . import mesh

_initialized = False

#: the default per-attempt connect timeout (seconds)
DEFAULT_TIMEOUT_S = 300.0


def backend_for(device: str) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors (asked for explicitly)."""
    if device == "cpu":
        return "gloo"
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA process group needs a card, and this machine has none: pass "
            "device='cpu' (--device cpu) for a gloo group on the CPU")
    if not dist.is_nccl_available():
        raise RuntimeError("this torch build has no NCCL; the card's process group needs it")
    return "nccl"


def _connect(backend: str, coordinator: Optional[str], num_processes: Optional[int],
             process_id: Optional[int], timeout_s: float) -> None:
    """One connection attempt: the coordinator's TCPStore (or the launcher's
    environment) and the process group on it."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://", timeout=timeout,
                                world_size=num_processes or -1,
                                rank=-1 if process_id is None else process_id)
        return
    if num_processes is None or process_id is None:
        raise ValueError("an explicit coordinator needs num_processes and process_id")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator must be host:port, got {coordinator!r}")
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
    max_retries: int = 3,
    backoff_s: float = 1.0,
    timeout_s: Optional[float] = None,
    device: str = "cuda",
) -> None:
    """Bring up the process group (idempotent).

    A bring-up is the flakiest moment of a multi-process run: the
    coordinator may not be listening yet when a worker comes up.  Connection
    attempts are therefore retried with exponential backoff (``max_retries``
    retries, ``backoff_s * 2**attempt`` sleeps, ``timeout_s`` per attempt).
    On exhaustion the last error propagates and :func:`is_initialized`
    stays False, so a later call may retry cleanly.  On the card the process
    then takes its own card.
    """
    global _initialized
    if _initialized:
        return
    backend = backend_for(device)
    last_err: Optional[BaseException] = None
    for attempt in range(max_retries + 1):
        if attempt:
            time.sleep(backoff_s * 2 ** (attempt - 1))
        try:
            _connect(backend, coordinator, num_processes, process_id,
                     DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s)
        except (RuntimeError, ConnectionError, TimeoutError, OSError) as e:
            last_err = e
            if dist.is_initialized():
                dist.destroy_process_group()
            continue
        _initialized = True
        if backend == "nccl":
            local = (local_device_ids[0] if local_device_ids
                     else dist.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(local)
        return
    raise RuntimeError(
        f"torch.distributed process group start-up failed after {max_retries + 1} attempts"
    ) from last_err


def shutdown() -> None:
    """Tear the process group down (a no-op when none is up)."""
    global _initialized
    mesh.forget_grids()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_initialized() -> bool:
    return _initialized


def process_count() -> int:
    """The process group's world size (1 with no group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 with no group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_distributed() -> bool:
    return process_count() > 1


def process_summary() -> str:
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
    else:
        backend = "none"
    dev = (f"cuda:{torch.cuda.current_device()}" if backend == "nccl" else "cpu")
    return (f"process {process_index()}/{process_count()}: {backend} process group, "
            f"local device {dev} (pid {os.getpid()})")
