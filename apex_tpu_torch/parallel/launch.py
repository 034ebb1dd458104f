"""Multi-process bring-up: ``distributed_init`` and rank helpers.

Port of ``apex_tpu/parallel/launch.py``. :func:`distributed_init` starts
the default ``torch.distributed`` process group with the launcher's
environment conventions (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``; explicit arguments first): NCCL for ``cuda``, gloo for
``device="cpu"``. With no environment and no arguments it does nothing,
as a reference script run without the launcher.

``enable_crash_dumps`` needs the JAX package's ``trace`` and ``cluster``
and ``elastic_run`` its ``cluster`` (the port has ``ckpt`` and
``utils.backoff``); they raise until those are ported (ROADMAP.md queue
A, items 10b and 11).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["distributed_init", "is_distributed", "process_index",
           "process_count", "maybe_print", "enable_crash_dumps",
           "elastic_run", "shrink_schedule"]


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     init_method: Optional[str] = None, device="cuda",
                     timeout_s: Optional[float] = None) -> None:
    """Start the default process group, tolerating the launcher's env.

    Per field: the argument, else ``MASTER_ADDR:MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``. ``coordinator_address`` ("host:port")
    becomes ``init_method="tcp://host:port"``; ``init_method`` may be
    given instead (``file://``, ``tcp://``). The backend is NCCL for a
    ``cuda`` device, whose index (``LOCAL_RANK``, else the rank modulo the
    cards present) becomes the group's ``device_id``, and gloo for
    ``cpu``. Single process (no env, no args) and a second call are
    no-ops."""
    if dist.is_initialized():
        return
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", "1234")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if (coordinator_address is None and init_method is None
            and num_processes is None and process_id is None):
        return                          # single process: nothing to start
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("distributed_init needs coordinator_address, "
                             "init_method or MASTER_ADDR")
        init_method = f"tcp://{coordinator_address}"
    rank = process_id if process_id is not None else 0
    device = torch.device(device)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if device.type == "cuda":
        index = device.index
        if index is None:
            index = int(os.environ.get(
                "LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        world_size=num_processes if num_processes is not None else 1,
        rank=rank, **kwargs)


def enable_crash_dumps(*args, **kwargs):
    raise NotImplementedError(
        "enable_crash_dumps needs trace/ and cluster/, not ported yet "
        "(ROADMAP.md queue A, items 10 and 11)")


def elastic_run(*args, **kwargs):
    raise NotImplementedError(
        "elastic_run needs cluster/, not ported yet (ROADMAP.md queue A, "
        "item 10b: data/, cluster/, elastic_run and the ImageNet example)")


def shrink_schedule(world: int, *, min_world: int = 1,
                    factor: int = 2) -> list:
    """The default mesh-shrink ladder: ``world, world//factor, ...`` down
    to ``min_world``."""
    if int(factor) < 2:
        raise ValueError(f"shrink factor must be >= 2, got {factor} "
                         f"(factor 1 would never shrink)")
    out, w = [], int(world)
    while w >= max(int(min_world), 1):
        out.append(w)
        if w == 1:
            break
        w //= int(factor)
    return out


def is_distributed() -> bool:
    return process_count() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


#: print verbosity (``_amp_state.verbosity``): 0 silences maybe_print
verbosity = 1


def maybe_print(msg: str, rank0: bool = False) -> None:
    """Verbosity- and rank-aware print."""
    if verbosity <= 0:
        return
    if rank0 and process_index() != 0:
        return
    print(msg)
