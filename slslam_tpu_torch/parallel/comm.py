"""The distributed layer's one collective: a summing all-reduce.

Every collective of the sharded window BA, of the sharded PGO and of the
gather of line shards goes through :func:`all_reduce_sum`, which packs its
tensors into one flat buffer, reduces it with one ``dist.all_reduce`` and
counts the call, its bytes (the buffer one rank sends) and the seconds
spent inside it.  :func:`comm_counts` is how the port states the JAX
package's contract "collective bytes per LM iteration independent of the
map size", which the JAX tests read from compiled HLO
(tests/test_distributed.py:73-90).

The seconds are host wall time around the collective; for CUDA tensors the
current stream is synchronized before and after it, so that neither the
work queued before it nor an NCCL reduction still in flight is
misattributed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch
import torch.distributed as dist

# collectives, bytes sent by this rank and seconds inside them since the
# last reset_comm_counts()
_counts: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_comm_counts():
    _counts.update(calls=0, bytes=0, seconds=0.0)


def comm_counts() -> Dict[str, float]:
    """{"calls", "bytes", "seconds"} of this rank's collectives since the
    last reset."""
    return dict(_counts)


def all_reduce_sum(group, *tensors):
    """The sums over the ranks of ``group`` of ``tensors`` (one dtype, one
    device), in one collective; returns them in their shapes.  The result
    is the same bytes on every rank, so ranks that branch on it stay in
    lockstep."""
    dtype, dev = tensors[0].dtype, tensors[0].device
    for t in tensors:
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"all_reduce_sum: {t.dtype} on {t.device} "
                             f"beside {dtype} on {dev}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.current_stream(dev).synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if cuda:
        torch.cuda.current_stream(dev).synchronize()
    _counts["seconds"] += time.perf_counter() - t0
    _counts["calls"] += 1
    _counts["bytes"] += flat.numel() * flat.element_size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return tuple(out)


def all_gather_shards(group, local):
    """(world, *local.shape): every rank's ``local`` (one shape on every
    rank), stacked by rank.  An all-reduce of a zero buffer that holds
    this rank's row, so it is exact and counted with the others."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    buf = torch.zeros((world,) + tuple(local.shape), dtype=local.dtype,
                      device=local.device)
    buf[rank] = local
    return all_reduce_sum(group, buf)[0]
