"""The device list that the sharded engine and the training step split
rows over: the counterpart of the JAX package's 1-D data mesh.

A mesh here is a plain list of ``torch.device``. Rows are split over its
entries in order; the tables are replicated once per distinct device. A
list may repeat a device (``[cuda:0, cuda:0]`` splits rows two ways on
one card), and ``device="cpu"`` gives a list of CPU entries, which runs
the same splits with the plain PyTorch versions.

Across processes (the JAX package's mesh over several hosts, after
``jax.distributed.initialize()``), a rank's mesh is its own device list,
usually ``[torch.device("cuda", local_rank)]``, and a ``torch.distributed``
process group spans the ranks: the caller creates the group and passes it
with the mesh (``ShardedEngine(engine, mesh, group=...)``,
``corpus_pair_counts(..., group=...)``). NCCL needs the mesh's first
device to be the current CUDA device (``torch.cuda.set_device``); gloo
runs its collectives on the CPU, whatever devices the mesh holds.
"""

from __future__ import annotations

import torch


def data_mesh(n_devices: int | None = None, *, device: str = "cuda") -> list[torch.device]:
    """The first ``n_devices`` visible GPUs (all of them if None), or with
    ``device="cpu"`` ``n_devices`` (default 1) CPU entries. Without CUDA a
    GPU mesh raises; it never falls back to the CPU. Across processes, pass
    each rank its own list (``[torch.device("cuda", local_rank)]``)."""
    if device == "cpu":
        return [torch.device("cpu")] * (1 if n_devices is None else n_devices)
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a CPU mesh")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"requested {n} devices, have {count}")
    return [torch.device("cuda", i) for i in range(n)]
