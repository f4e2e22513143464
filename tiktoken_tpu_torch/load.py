"""Vocabulary loading: the ``.tiktoken`` format from a local file.

The port reads vocabularies from disk only: no blob cache and no HTTP.
"""

from __future__ import annotations

import base64


def load_tiktoken_bpe(tiktoken_bpe_file: str) -> dict[bytes, int]:
    """Parse the ``.tiktoken`` format: ``base64(token) <space> rank`` lines."""
    with open(tiktoken_bpe_file, "rb") as f:
        contents = f.read()
    ranks: dict[bytes, int] = {}
    for line in contents.splitlines():
        if not line:
            continue
        try:
            token_b64, rank_str = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank_str)
        except ValueError as e:
            raise ValueError(f"Error parsing line {line!r} in {tiktoken_bpe_file}") from e
    return ranks
