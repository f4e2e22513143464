"""BPE vocabulary training on the host: the port's copy of the JAX
package's ``tiktoken_tpu/train.py``.

Greedy training as in the reference's educational module (reference:
tiktoken/_educational.py:119-185): count adjacent token pairs over the
pre-tokenized corpus and merge the most common pair, repeatedly, with a
piece histogram and incremental pair-count upkeep so that large
vocabularies train at practical speed. Pre-tokenization uses the port's
own splitter (``_pybpe.HostBPE.split``: a char-level DFA of the pattern,
or the ``regex`` module for a pattern outside the DFA's dialect).

Vocabularies produced here satisfy the invariants the whole framework
relies on (reference: src/lib.rs:145-147):

- rank order equals merge priority;
- every multi-byte token is the concatenation of two earlier-rank tokens,
  so pair ranks can be looked up by concatenated bytes (or token-id pairs).

The device-side pair count over a corpus, summed over devices and
processes, is ``tiktoken_tpu_torch.parallel.train``.
"""

from __future__ import annotations

import heapq
from collections import Counter, defaultdict
from typing import Iterable, Sequence

from tiktoken_tpu_torch._pybpe import HostBPE


def _pretokenize_histogram(texts: Iterable[str], pat_str: str) -> Counter[bytes]:
    split = HostBPE({}, {}, pat_str).split
    hist: Counter[bytes] = Counter()
    for text in texts:
        for piece in split(text):
            hist[piece.encode("utf-8")] += 1
    return hist


def train_bpe(
    texts: Iterable[str],
    vocab_size: int,
    pat_str: str,
    *,
    min_pair_count: int = 2,
) -> dict[bytes, int]:
    """Train a BPE vocabulary of up to ``vocab_size`` ranks.

    Greedy training: tokens 0..255 are the single bytes; each subsequent
    rank merges the currently most frequent adjacent token pair (ties
    broken by smaller concatenated bytes, for determinism). Stops early
    when no pair occurs at least ``min_pair_count`` times.
    """
    assert vocab_size >= 256, "vocab must at least cover all single bytes"
    ranks: dict[bytes, int] = {bytes([i]): i for i in range(256)}

    hist = _pretokenize_histogram(texts, pat_str)
    # Each piece is a list of current token byte-strings plus its multiplicity.
    pieces: list[list[bytes]] = []
    counts: list[int] = []
    for piece_bytes, count in hist.items():
        if len(piece_bytes) < 2:
            continue
        pieces.append([bytes([b]) for b in piece_bytes])
        counts.append(count)

    # pair -> total count; pair -> set of piece indices containing it
    pair_counts: Counter[tuple[bytes, bytes]] = Counter()
    pair_sites: defaultdict[tuple[bytes, bytes], set[int]] = defaultdict(set)
    for idx, toks in enumerate(pieces):
        c = counts[idx]
        for a, b in zip(toks, toks[1:]):
            pair_counts[(a, b)] += c
            pair_sites[(a, b)].add(idx)

    # Lazy max-heap over (-count, concat_bytes, pair).
    heap: list[tuple[int, bytes, tuple[bytes, bytes]]] = [
        (-c, a + b, (a, b)) for (a, b), c in pair_counts.items()
    ]
    heapq.heapify(heap)

    while len(ranks) < vocab_size and heap:
        neg_count, concat, pair = heapq.heappop(heap)
        current = pair_counts.get(pair, 0)
        if current != -neg_count:
            if current > 0:
                heapq.heappush(heap, (-current, concat, pair))
            continue  # stale heap entry
        if current < min_pair_count:
            break
        if concat in ranks:
            # The same byte-string can arise from two different splits; the
            # rank table is keyed by bytes, so drop the duplicate pair.
            del pair_counts[pair]
            pair_sites.pop(pair, None)
            continue

        ranks[concat] = len(ranks)
        a, b = pair

        touched: set[tuple[bytes, bytes]] = set()
        for idx in list(pair_sites.get(pair, ())):
            toks = pieces[idx]
            c = counts[idx]
            i = 0
            while i < len(toks) - 1:
                if toks[i] == a and toks[i + 1] == b:
                    # Update neighbouring pair counts.
                    if i > 0:
                        left = (toks[i - 1], a)
                        pair_counts[left] -= c
                        touched.add(left)
                        new_left = (toks[i - 1], concat)
                        pair_counts[new_left] += c
                        pair_sites[new_left].add(idx)
                        touched.add(new_left)
                    if i + 2 < len(toks):
                        right = (b, toks[i + 2])
                        pair_counts[right] -= c
                        touched.add(right)
                        new_right = (concat, toks[i + 2])
                        pair_counts[new_right] += c
                        pair_sites[new_right].add(idx)
                        touched.add(new_right)
                    toks[i : i + 2] = [concat]
                else:
                    i += 1
        del pair_counts[pair]
        pair_sites.pop(pair, None)

        for p in touched:
            c = pair_counts.get(p, 0)
            if c <= 0:
                pair_counts.pop(p, None)
                pair_sites.pop(p, None)
            else:
                heapq.heappush(heap, (-c, p[0] + p[1], p))

    return ranks


def train_bpe_from_files(
    paths: Sequence[str], vocab_size: int, pat_str: str, **kwargs
) -> dict[bytes, int]:
    def _iter():
        for path in paths:
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                yield f.read()

    return train_bpe(_iter(), vocab_size, pat_str, **kwargs)
