"""Multi-process startup over ``torch.distributed``.

Port of ``slslam_tpu/parallel/multihost.py``.  Where the JAX package runs
one program per host over the global device set (``jax.distributed``), the
port runs one process per rank, each with its own device, joined in one
process group; the engine's ``mesh_devices`` is that group's world size.

Two ways to start the ranks, one command per rank:

  torchrun --nproc-per-node 2 -m slslam_tpu_torch.cli sim ... \\
      --mesh-devices 2
  python -m slslam_tpu_torch.cli sim ... --mesh-devices 2 --multihost \\
      --coordinator host0:8476 --num-processes 2 --process-id $ID

or programmatically: ``initialize_multihost(...)`` before building the
engine, or ``run_local_ranks`` to spawn the ranks of one host from one
process.

**The backend rule.**  A rank on the card uses ``cuda:{local rank % card
count}``.  The group runs NCCL when every rank has a card of its own (the
ranks of this host are no more than its cards) and gloo when ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU; gloo
all-reduces CUDA tensors through the host.  A host's rank count and each
rank's local rank come from torchrun (LOCAL_WORLD_SIZE, LOCAL_RANK); under
the explicit flags the ranks tell each other their host names through the
coordinator's store before the group starts, and count those equal to
their own.  The backend is chosen once,
before the group starts, and never switched after a failure: a failed
start, a failed collective or a rank that stops answering within the
group's timeout raises.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import socket
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

# seconds a collective (and the group's start) may wait for the other ranks
DEFAULT_TIMEOUT_S = 600.0


def backend_for(device, local_processes: int) -> str:
    """The backend rule: "nccl" when the ranks run on CUDA and this host's
    ``local_processes`` ranks have a card each, else "gloo"."""
    if (torch.device(device).type == "cuda"
            and local_processes <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: ``cuda:{local_rank % card count}`` for a CUDA
    request (which needs a card), the CPU as asked."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def host_ranks(store, world: int, rank: int, host: str):
    """(local rank, ranks on this host): every rank of the ``world`` puts
    its ``host`` name in ``store`` and waits for the others'; the ranks on
    one host are those that gave the same name, in rank order."""
    names = dist.PrefixStore("slslam_host", store)
    names.set(str(rank), host)
    names.wait([str(r) for r in range(world)])
    hosts = [names.get(str(r)).decode() for r in range(world)]
    return hosts[:rank].count(host), hosts.count(host)


def _start(world, rank, device, local_rank, local_processes, timeout_s,
           init_method=None, store=None):
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev, local_processes)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev, backend


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         timeout_s: float = DEFAULT_TIMEOUT_S):
    """``dist.init_process_group`` for this rank, with an explicit or a
    torchrun topology (the JAX ``initialize_multihost``, multihost.py:
    23-45).

    With ``coordinator_address`` ("host:port", rank 0's host),
    ``num_processes`` and ``process_id``, the group meets in a TCP store
    that rank 0 serves at ``coordinator_address``, where the ranks first
    count the ranks of each host (``host_ranks``); without them it reads
    torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE).  Returns {"process_index",
    "process_count", "local_rank", "device", "backend"}."""
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        world, rank = int(num_processes), int(process_id)
        host, _, port = coordinator_address.rpartition(":")
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                              timeout=datetime.timedelta(seconds=timeout_s))
        local_rank, local_processes = host_ranks(store, world, rank,
                                                 socket.gethostname())
        dev, backend = _start(world, rank, device, local_rank,
                              local_processes, timeout_s, store=store)
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"initialize_multihost: no coordinator given "
                               f"and torchrun's {missing} are not set")
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ["LOCAL_RANK"])
        dev, backend = _start(world, rank, device, local_rank,
                              int(os.environ["LOCAL_WORLD_SIZE"]), timeout_s,
                              init_method="env://")
    return {"process_index": rank, "process_count": world,
            "local_rank": local_rank, "device": str(dev),
            "backend": backend}


def is_primary() -> bool:
    """True on the rank that writes outputs and logs: rank 0, or the only
    process when no group is initialized."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(fn, rank, world, init_method, device, timeout_s, args, out):
    try:
        dev, _ = _start(world, rank, device, rank, world, timeout_s,
                        init_method=init_method)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        out.put((rank, True, fn(rank, world, dev, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_ranks(fn, world: int, args=(), device="cuda",
                    timeout_s: float = 120.0):
    """Spawn ``world`` ranks on this host, each calling ``fn(rank, world,
    device, *args)`` inside its process group (the backend rule above; the
    group meets in a file under a fresh temporary directory, so concurrent
    runs never share a port), and return their results by rank.

    ``fn`` must be importable (a module-level function) and its results
    picklable.  Raises if a rank fails, or if the ranks do not all finish
    within ``timeout_s`` (then every rank is killed); every process it
    starts has ended when it returns or raises."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="slslam_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, init_method, str(device), timeout_s, args, out))
        for r in range(world)]
    results, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < world and not errors:
            try:
                rank, ok, val = out.get(timeout=min(
                    1.0, max(deadline - time.monotonic(), 0.01)))
            except queue_mod.Empty:
                late = sorted(set(range(world)) - set(results))
                dead = [r for r in late if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"run_local_ranks: ranks {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]}") from None
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"run_local_ranks: ranks {late} of {world} did not "
                        f"finish within {timeout_s} s") from None
                continue
            if ok:
                results[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors:
            raise RuntimeError("run_local_ranks: " + "\n".join(errors))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 5.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
