"""Multi-process start-up and host-local data, on ``torch.distributed``.

Counterpart of ``rtvc_tpu/parallel/multihost.py``. JAX runs one
controller per host over a global device set; the port runs one process
per rank (one card each, or ranks sharing a card), joined by a
``torch.distributed`` process group:

- :func:`initialize_distributed` starts that group from its arguments or
  from JAX's environment variables (``COORDINATOR_ADDRESS``,
  ``NUM_PROCESSES``, ``PROCESS_ID``); where none is set it reads
  torchrun's (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``),
  the GPU's counterpart of JAX's pod autodetect, and with neither it
  stays single-process and returns False, as JAX's non-pod path does;
- :func:`placement` picks each rank's card and the backend from what
  every rank reports at the rendezvous (its machine, and the cards it
  sees or the one it was given): ``nccl`` where every rank owns a card of
  its own, ``gloo`` on the CPU and where ranks share a card (NCCL refuses
  two ranks on one device);
- :func:`host_batch_slice` is a copy of JAX's (a test holds the two
  equal);
- :func:`shard_host_local_batch` moves this rank's rows, which it already
  holds, to its device; in a one-process run it is ``shard_batch``.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import socket
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

PyTree = Any

# a rank that waits longer than this on a collective raises instead of
# hanging the run
TIMEOUT = datetime.timedelta(minutes=10)

# the device initialize_distributed chose for this process
_DEVICE: Optional[torch.device] = None


def rank_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` where given, else the
    one :func:`initialize_distributed` chose, else card ``LOCAL_RANK``
    (torchrun's; 0 where unset) of this machine's, else the CPU."""
    if device is not None:
        return torch.device(device)
    if _DEVICE is not None:
        return _DEVICE
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                            % torch.cuda.device_count())
    return torch.device("cpu")


def placement(machines: Sequence[Tuple[str, int]], rank: int
              ) -> Tuple[Optional[int], str]:
    """This rank's card index (None: the CPU) and the group's backend.

    ``machines[r]`` is what rank ``r`` reported: a key naming the cards it
    can reach (its host and ``CUDA_VISIBLE_DEVICES``, or one given card)
    and how many there are (0: none). The ranks with one key take its
    cards in rank order, wrapping where they outnumber them. The backend
    is ``nccl`` where no key has more ranks than cards, else ``gloo``;
    every rank computes it from the same list, so all agree."""
    key, cards = machines[rank]
    local = [r for r, (k, _) in enumerate(machines) if k == key]
    ranks = collections.Counter(k for k, _ in machines)
    nccl = all(c > 0 and ranks[k] <= c for k, c in machines)
    index = local.index(rank) % cards if cards else None
    return index, "nccl" if nccl else "gloo"


def _report(device) -> Tuple[str, int]:
    """What this rank tells the others (see :func:`placement`)."""
    host = (f"{socket.gethostname()}|"
            f"{os.environ.get('CUDA_VISIBLE_DEVICES', '*')}")
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return host, 0
        return f"{host}|cuda:{dev.index or 0}", 1
    return host, torch.cuda.device_count() if torch.cuda.is_available() \
        else 0


def exchange(store, rank: int, world_size: int, device=None
             ) -> List[Tuple[str, int]]:
    """Every rank's :func:`_report`, through the rendezvous ``store``."""
    store = dist.PrefixStore("rtvc_placement", store)
    store.set(str(rank), json.dumps(_report(device)))
    return [tuple(json.loads(store.get(str(r)))) for r in range(world_size)]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> bool:
    """Start the process group from the arguments or the environment (see
    the module docstring) and return ``world_size > 1``. A coordinator
    ``host:port`` becomes ``tcp://host:port``; a full URL (``tcp://``,
    ``file://``) is used as it is. The ranks meet at that store, report
    their machines (:func:`exchange`), and each takes the card (``device``
    where given) and the backend :func:`placement` gives;
    :func:`rank_device` returns that card from then on. An existing group
    is kept."""
    global _DEVICE
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if coordinator_address is None and num_processes is None:
        # torchrun's variables: the launcher's own rendezvous
        if not (os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE")
                and os.environ.get("RANK") is not None):
            return False
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        init = "env://"
    else:
        if coordinator_address is None or num_processes is None \
                or process_id is None:
            raise ValueError(
                "initialize_distributed needs the coordinator address, the "
                "number of processes and this process's id together "
                f"(got {coordinator_address!r}, {num_processes!r}, "
                f"{process_id!r})")
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
    store, rank, world = next(dist.rendezvous(
        init, int(process_id), int(num_processes), timeout=TIMEOUT))
    store.set_timeout(TIMEOUT)
    index, backend = placement(exchange(store, rank, world, device), rank)
    dev = (torch.device(device) if device is not None
           else torch.device("cuda", index) if index is not None
           else torch.device("cpu"))
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "nccl":
        kwargs["device_id"] = dev
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=TIMEOUT, **kwargs)
    _DEVICE = dev
    return dist.get_world_size() > 1


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_batch_slice(global_batch: int, process_index: int,
                     process_count: int) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this host must load.

    The global batch divides evenly across hosts (callers enforce
    ``global_batch % process_count == 0`` — the dp-mesh construction in
    train.py already guarantees a dp-divisible batch, and dp is a multiple
    of process_count on any contiguous mesh)."""
    if global_batch % process_count:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} hosts")
    per_host = global_batch // process_count
    start = process_index * per_host
    return start, start + per_host


def shard_host_local_batch(batch: PyTree, mesh) -> PyTree:
    """This rank's rows, which ``batch`` already holds (see
    :func:`host_batch_slice`), on its device; no rows cross ranks. In a
    one-process run the batch is the global one and this is
    :func:`~.mesh.shard_batch`."""
    from .mesh import place_batch, shard_batch

    if process_count() == 1:
        return shard_batch(batch, mesh)
    return place_batch(batch, mesh.device)
