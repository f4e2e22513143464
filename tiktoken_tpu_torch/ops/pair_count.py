"""The pair-count training step, plain PyTorch: the spec of the
``pair_count`` kernel (``csrc/pair_count.cu``) and its CPU path.

The counterpart of the JAX package's ``parallel/train.py``
``make_pair_count_step.per_shard`` and ``_pair_hash``, without the
all-reduce (``parallel/train.corpus_pair_counts`` sums the shards):

- ``pair_hash``: the uint32 pair hash, ``ops/pair_table.mix`` with seed 0,
  masked to ``bits``;
- ``pair_hist``: for every alive position ``k`` of a row, ``nxt`` is the
  smallest alive column after it (or K); the pair (token[k], token[nxt])
  counts when ``nxt < K`` and ``nxt`` does not start a piece. Only
  ``piece_start`` at ``nxt`` is read, not the dead columns between;
- ``hist_argmax``: the first bin of the maximum, as ``jnp.argmax``.

Arithmetic on uint32 values runs in int64 tensors masked to 32 bits
(``mul32``), never in ``torch.uint32``.
"""

from __future__ import annotations

import torch

from tiktoken_tpu_torch.ops.pair_table import M32, mix


def pair_hash(a: torch.Tensor, b: torch.Tensor, bits: int) -> torch.Tensor:
    """Bins of the pairs (a, b) of uint32 values (any integer tensors;
    int32 bit patterns are read as uint32) -> int64 in [0, 2^bits)."""
    a = a.to(torch.int64) & M32
    b = b.to(torch.int64) & M32
    return mix(a, b, 0) & ((1 << bits) - 1)


def pair_bins(tokens: torch.Tensor, alive: torch.Tensor, piece_start: torch.Tensor,
              bits: int) -> torch.Tensor:
    """The bin of every counted pair of a [B, K] grid, flattened (int64)."""
    B, K = tokens.shape
    if B * K == 0:
        return torch.zeros(0, dtype=torch.int64, device=tokens.device)
    idx = torch.arange(K, dtype=torch.int64, device=tokens.device)
    alive_idx = torch.where(alive, idx[None, :], K)
    # smallest alive index >= k, by a reverse cumulative minimum
    nxt_incl = torch.flip(torch.cummin(torch.flip(alive_idx, (1,)), dim=1).values, (1,))
    nxt = torch.cat([nxt_incl[:, 1:], torch.full((B, 1), K, dtype=torch.int64,
                                                 device=tokens.device)], dim=1)
    nxt_c = nxt.clamp(max=K - 1)
    right = torch.take_along_dim(tokens, nxt_c, dim=1)
    same_piece = ~torch.take_along_dim(piece_start, nxt_c, dim=1)
    ok = alive & (nxt < K) & same_piece
    return pair_hash(tokens[ok], right[ok], bits)


def pair_hist(tokens: torch.Tensor, alive: torch.Tensor, piece_start: torch.Tensor,
              bits: int) -> torch.Tensor:
    """(tokens [B, K] i32, alive [B, K] bool, piece_start [B, K] bool) ->
    hist [2^bits] i32 of the counted pairs' bins."""
    bins = pair_bins(tokens, alive, piece_start, bits)
    hist = torch.zeros(1 << bits, dtype=torch.int32, device=tokens.device)
    return hist.index_add_(0, bins, torch.ones_like(bins, dtype=torch.int32))


def hist_argmax(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hist [n] i32 -> (best_bin, best_count), 0-d int32 tensors: the first
    index of the maximum (bin 0, count 0 for an all-zero histogram)."""
    best = torch.argmax(hist)  # the first index of the maximum
    return best.to(torch.int32), hist[best].to(torch.int32)
