"""The distributed pair-count training step.

The counterpart of the JAX package's ``parallel/train.py``: every device
counts the adjacent-token pairs of its rows into a hashed histogram (the
``pair_count`` kernel, ``csrc/pair_count.cu``; its plain version
``ops/pair_count.py`` on the CPU), the histograms are summed onto the
mesh's first device (the in-process ``psum``) and, when a
``torch.distributed`` process group is given, all-reduced over it
(``parallel/collective.all_reduce_sum``: NCCL on the mesh's first device,
which must be the current one, gloo on the CPU; the counterpart of a mesh
that spans hosts); the argmax of the sum is the next merge.

A pair counts when both positions are alive, the right one is the next
alive column of the row, and it does not start a piece. The exact host
trainer is ``tiktoken_tpu_torch.train.train_bpe``.
"""

from __future__ import annotations

import numpy as np
import torch

from tiktoken_tpu_torch.ops import kernels
from tiktoken_tpu_torch.ops.engine import to_device
from tiktoken_tpu_torch.ops.pair_count import hist_argmax, pair_hash, pair_hist
from tiktoken_tpu_torch.parallel.collective import all_reduce_sum

HIST_BITS = 20  # 1M bins: collision-negligible for early merge rounds

__all__ = ["HIST_BITS", "corpus_pair_counts", "pair_count_step", "pair_hash"]


def pair_count_step(tokens: torch.Tensor, alive: torch.Tensor, piece_start: torch.Tensor, *,
                    hist_bits: int = HIST_BITS):
    """One shard's step in plain PyTorch: (tokens [B, K] i32, alive,
    piece_start [B, K] bool) -> (hist [2^bits] i32, best_bin, best_count)."""
    hist = pair_hist(tokens, alive, piece_start, hist_bits)
    best_bin, best_count = hist_argmax(hist)
    return hist, best_bin, best_count


def _pad_rows(x: np.ndarray, rows: int, fill) -> np.ndarray:
    """``x`` with rows of ``fill`` appended up to ``rows`` rows."""
    if x.shape[0] == rows:
        return x
    return np.concatenate([x, np.full((rows - x.shape[0],) + x.shape[1:], fill, x.dtype)])


def corpus_pair_counts(mesh, tokens, alive, piece_start, *, hist_bits: int = HIST_BITS,
                       group=None) -> tuple[np.ndarray, int, int]:
    """Count the pairs of a [B, K] grid split over ``mesh`` (a list of
    devices, ``parallel.data_mesh``): tokens uint32, alive and piece_start
    bool, as numpy arrays. Rows are split in order, ceil(B / len(mesh)) per
    device, and a short share is padded (tokens 0, alive False,
    piece_start True), as JAX pads the rows to a multiple of the mesh;
    only the padded shares are copied on the host. Each device's share goes
    up as a pinned, non-blocking copy (``ops.engine.to_device``) and the
    device runs the kernel on it; the histograms are summed on
    ``mesh[0]``, all-reduced over ``group`` if one is given (every rank
    calls with its own rows), and the argmax taken there. Returns (hist
    int32, best_bin, best_count)."""
    n = len(mesh)
    grid = ((np.ascontiguousarray(tokens, dtype=np.uint32).view(np.int32), 0),
            (np.ascontiguousarray(alive, dtype=bool), False),
            (np.ascontiguousarray(piece_start, dtype=bool), True))
    per = -(-grid[0][0].shape[0] // n)
    hists = []
    for d, dev in enumerate(mesh):  # every device's step enqueued before any is read
        share = [_pad_rows(x[d * per : (d + 1) * per], per, fill) for x, fill in grid]
        hists.append(kernels.pair_hist(*(to_device(x, torch.device(dev)) for x in share),
                                       hist_bits))
    total = hists[0]
    for h in hists[1:]:
        total += h.to(total.device)
    if group is not None:
        total = all_reduce_sum(total, group, mesh[0])
    best_bin, best_count = kernels.hist_argmax(total)
    return total.cpu().numpy(), int(best_bin), int(best_count)
