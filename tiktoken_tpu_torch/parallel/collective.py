"""The few collectives that the sharded engine runs across processes.

The counterpart of what the JAX package does over a mesh that spans
processes: ``psum`` of per-shard counters (``tiktoken_tpu/parallel/
encode.py``) and ``multihost_utils.process_allgather(tiled=True)`` of
the per-shard results (``tests/test_distributed.py``). Each helper takes
the ``torch.distributed`` process group and the rank's device
explicitly; every rank of the group calls it in the same order.

Where the tensors live follows the group's backend: NCCL on the rank's
CUDA device, which must be the current CUDA device; gloo on the CPU. A
backend or device that does not fit raises: nothing falls back quietly.
NCCL has no unsigned 32-bit type, so ids travel as an ``int32`` view.
"""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

import numpy as np
import torch
import torch.distributed as dist

T = TypeVar("T")
_I32 = np.iinfo(np.int32)


def collective_device(group, device) -> torch.device:
    """Where the collectives of ``group`` keep their tensors for a rank whose
    engines run on ``device``: that device under NCCL (it must be a CUDA
    device and the current one), the CPU under gloo."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend != "nccl":
        raise ValueError(f"unsupported process-group backend {backend!r}: use 'nccl' or 'gloo'")
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"an NCCL group needs the rank's engines on a CUDA device, got {device}")
    current = torch.device("cuda", torch.cuda.current_device())
    if device.index != current.index:
        raise RuntimeError(f"the rank's device {device} is not the current CUDA device "
                           f"{current}: call torch.cuda.set_device({device.index}) first")
    return current


def all_reduce_sum(t: torch.Tensor, group, device) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, on ``t``'s device (the
    ``psum``); the sum runs on ``collective_device(group, device)``."""
    where = collective_device(group, device)
    work = t if t.device == where else t.to(where)
    dist.all_reduce(work, op=dist.ReduceOp.SUM, group=group)
    if work is t:
        return t
    return t.copy_(work.to(t.device))


def run_agreed(fn: Callable[[], tuple[T, dict]], failed_counts: dict, group,
               device) -> tuple[T, dict]:
    """Run ``fn`` on this rank, which returns (its result, its counts: a
    dict of ints), then agree on failure and sum the counts over the ranks,
    in one ``all_reduce``. Returns (``fn``'s result, the summed counts); a
    rank whose ``fn`` raised adds ``failed_counts``, a dict of the same keys.

    If any rank's ``fn`` raised, every rank raises once all have arrived:
    the failing rank its own exception, the others a ``RuntimeError`` that
    names the failing ranks. So no rank goes on to a collective that a
    failed rank will never join."""
    try:
        (out, counts), err = fn(), None
    except Exception as e:  # re-raised below, once every rank knows
        out, counts, err = None, failed_counts, e
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    flags = [0] * world
    flags[rank] = int(err is not None)
    t = torch.tensor(flags + [int(v) for v in counts.values()], dtype=torch.int64)
    t = all_reduce_sum(t, group, device).tolist()
    failed = [r for r in range(world) if t[r]]
    if err is not None:
        raise err
    if failed:
        raise RuntimeError(f"rank(s) {failed} of the process group failed; rank {rank} stops "
                           "with them")
    return out, dict(zip(counts, t[world:]))


def _as_int32(a: np.ndarray) -> np.ndarray:
    """A flat int32 view or copy of ``a``: uint32 ids as their bit pattern,
    bools and small integers as values."""
    a = np.ascontiguousarray(a).reshape(-1)
    if a.dtype in (np.uint32, np.int32):
        return a.view(np.int32)
    if a.dtype != bool and a.size and (a.min() < _I32.min or a.max() > _I32.max):
        raise ValueError(f"values of {a.dtype} outside int32 cannot be gathered")
    return a.astype(np.int32)


def all_gather_ragged(arrays: Sequence[np.ndarray], group, device) -> list[list[np.ndarray]]:
    """Every rank's ``arrays``, in rank order: [rank][i]. The ranks pass the
    same number of arrays, each of the same dtype and trailing shape on
    every rank, with any number of rows. The sizes are gathered first; each
    rank's arrays then travel as one int32 buffer padded to the largest,
    in one ``all_gather`` (through pinned host memory under NCCL), and come
    back as views of the gathered buffer where the dtype allows."""
    where = collective_device(group, device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    sizes = torch.tensor([a.size for a in arrays], dtype=torch.int64)
    all_sizes = torch.empty((world, len(arrays)), dtype=torch.int64, device=where)
    dist.all_gather(list(all_sizes.unbind(0)), sizes.to(where), group=group)
    all_sizes = all_sizes.cpu().numpy()
    width = max(1, int(all_sizes.sum(axis=1).max()))
    pinned = where.type == "cuda"
    send = torch.empty(width, dtype=torch.int32, pin_memory=pinned)
    n = int(all_sizes[rank].sum())
    if n:
        np.concatenate([_as_int32(a) for a in arrays], out=send.numpy()[:n])
    recv = torch.empty((world, width), dtype=torch.int32, device=where)
    dist.all_gather(list(recv.unbind(0)), send.to(where, non_blocking=True), group=group)
    if pinned:
        recv = torch.empty((world, width), dtype=torch.int32, pin_memory=True).copy_(recv)
    got = recv.numpy()
    out = []
    for r in range(world):
        offs = np.concatenate([[0], np.cumsum(all_sizes[r])])
        parts = []
        for i, a in enumerate(arrays):
            part = got[r, offs[i] : offs[i + 1]]
            part = part.view(a.dtype) if a.dtype == np.uint32 else part.astype(a.dtype)
            parts.append(part.reshape((-1,) + a.shape[1:]))
        out.append(parts)
    return out
