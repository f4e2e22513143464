"""An educational, pure-Python byte pair encoding.

The reference's educational module (``SimpleBytePairEncoding``,
``bpe_encode``, ``bpe_train``, ``visualise_tokens``,
``train_simple_encoding``; reference: tiktoken/_educational.py:12-223),
with the same names and printed output. Text is split by the port's char
DFA (``_pybpe.HostBPE.split``), so the shipped patterns need no ``regex``
module; merging is the greedy rule of ``_pybpe``, re-run step by step to
show it; the production trainer is ``tiktoken_tpu_torch.train.train_bpe``.
"""

from __future__ import annotations

from collections import Counter

import tiktoken_tpu_torch
from tiktoken_tpu_torch._pybpe import HostBPE

_PALETTE = (167, 179, 185, 77, 80, 68, 134)


class SimpleBytePairEncoding:
    """A small, readable BPE encoder, decoder and trainer."""

    def __init__(self, *, pat_str: str, mergeable_ranks: dict[bytes, int]) -> None:
        self.pat_str = pat_str
        self.mergeable_ranks = mergeable_ranks
        self._decoder = {rank: token for token, rank in mergeable_ranks.items()}
        self._splitter = HostBPE({}, {}, pat_str)

    def encode(self, text: str, visualise: str | None = "colour") -> list[int]:
        """Encode a string, printing every merge step unless ``visualise``
        is None."""
        out: list[int] = []
        for piece in self._splitter.split(text):
            out.extend(bpe_encode(self.mergeable_ranks, piece.encode("utf-8"), visualise))
        return out

    def decode_bytes(self, tokens: list[int]) -> bytes:
        return b"".join(self._decoder[t] for t in tokens)

    def decode(self, tokens: list[int]) -> str:
        # token boundaries need not be UTF-8 boundaries, hence "replace"
        return self.decode_bytes(tokens).decode("utf-8", errors="replace")

    def decode_tokens_bytes(self, tokens: list[int]) -> list[bytes]:
        return [self._decoder[t] for t in tokens]

    @staticmethod
    def train(training_data: str, vocab_size: int, pat_str: str) -> "SimpleBytePairEncoding":
        ranks = bpe_train(training_data, vocab_size, pat_str)
        return SimpleBytePairEncoding(pat_str=pat_str, mergeable_ranks=ranks)

    @staticmethod
    def from_tiktoken(encoding) -> "SimpleBytePairEncoding":
        """From an ``Encoding`` or the name of one in the port's registry."""
        if isinstance(encoding, str):
            encoding = tiktoken_tpu_torch.get_encoding(encoding)
        return SimpleBytePairEncoding(pat_str=encoding._pat_str,
                                      mergeable_ranks=encoding._mergeable_ranks)


def _merge_steps(ranks: dict[bytes, int], piece: bytes):
    """The token list after each greedy merge, ending at the fixed point."""
    segments = [piece[i : i + 1] for i in range(len(piece))]
    while True:
        yield segments
        best = min(
            ((rank, i) for i, (a, b) in enumerate(zip(segments, segments[1:]))
             if (rank := ranks.get(a + b)) is not None),
            default=None,
        )
        if best is None:
            return
        _, i = best
        segments = segments[:i] + [segments[i] + segments[i + 1]] + segments[i + 2 :]


def bpe_encode(ranks: dict[bytes, int], piece: bytes, visualise: str | None = "colour"
               ) -> list[int]:
    """Greedy BPE over one piece: merge the lowest-rank adjacent pair until
    none is left."""
    segments = [piece]
    for segments in _merge_steps(ranks, piece):
        if visualise in ("colour", "color"):
            visualise_tokens(segments)
        elif visualise == "simple":
            print(segments)
    if visualise:
        print()
    return [ranks[seg] for seg in segments]


def bpe_train(data: str, vocab_size: int, pat_str: str, visualise: str | None = "colour"
              ) -> dict[bytes, int]:
    """The BPE training loop in its simplest form: from the 256 single
    bytes, each round mints a token for the most frequent adjacent pair
    over the split corpus."""
    if vocab_size < 256:
        raise ValueError("vocab_size must be at least 256, so we can encode all bytes")
    ranks: dict[bytes, int] = {bytes([i]): i for i in range(256)}

    corpus: list[list[bytes]] = [
        [b[i : i + 1] for i in range(len(b))]
        for b in (piece.encode("utf-8") for piece in HostBPE({}, {}, pat_str).split(data))
    ]

    while len(ranks) < vocab_size:
        tally: Counter[tuple[bytes, bytes]] = Counter()
        for word in corpus:
            tally.update(zip(word, word[1:]))
        if not tally:
            break
        (left, right), _count = tally.most_common(1)[0]
        minted = left + right
        ranks[minted] = len(ranks)

        # the corpus with the new token in place of each pair
        for w, word in enumerate(corpus):
            rewritten: list[bytes] = []
            i = 0
            while i < len(word):
                if i + 1 < len(word) and word[i] == left and word[i + 1] == right:
                    rewritten.append(minted)
                    i += 2
                else:
                    rewritten.append(word[i])
                    i += 1
            corpus[w] = rewritten

        if visualise:
            print(f"Merge #{len(ranks) - 256}: {left!r} + {right!r} -> {minted!r}")
            if visualise in ("colour", "color"):
                print("The start of the training data now tokenises as:")
                visualise_tokens([tok for word in corpus[:50] for tok in word])
            elif visualise == "simple":
                for word in corpus[:20]:
                    print(word)
            print("\n")

    return ranks


def visualise_tokens(token_values: list[bytes]) -> None:
    """Print the tokens on alternating background colours."""
    shown = [tok.decode("utf-8", errors="replace") for tok in token_values]
    position = 0
    previous = None
    for value in shown:
        colour = _PALETTE[position % len(_PALETTE)]
        if colour == previous:
            colour = _PALETTE[(position + 1) % len(_PALETTE)]
        previous = colour
        position += len(value)
        print(f"\x1b[48;5;{colour}m{value}", end="")
    print("\x1b[0m")


def train_simple_encoding():
    """Train a small BPE tokeniser on this module's own source."""
    gpt2_pattern = (
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[\p{L}]+| ?[\p{N}]+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
    )
    with open(__file__) as f:
        data = f.read()

    enc = SimpleBytePairEncoding.train(data, vocab_size=600, pat_str=gpt2_pattern)

    print("This is the sequence of merges performed in order to encode 'hello world':")
    tokens = enc.encode("hello world")
    assert enc.decode(tokens) == "hello world"
    assert enc.decode_bytes(tokens) == b"hello world"
    assert enc.decode_tokens_bytes(tokens) == [b"hello", b" world"]

    return enc
