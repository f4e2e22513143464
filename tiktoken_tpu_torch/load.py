"""Vocabulary loading, caching and file formats.

The reference loader's functions and behaviour (reference:
tiktoken/load.py): a file cache keyed by sha1(path or URL), sha256
verification with eviction on a mismatch, writes published by an atomic
rename, a read-only default cache tolerated, the ``.tiktoken`` format, and
the GPT-2 data_gym converter (vocab.bpe + encoder.json) with its
encoder.json cross-check.

Cache directory: ``$TIKTOKEN_TPU_CACHE_DIR``, then ``$TIKTOKEN_CACHE_DIR``
and ``$DATA_GYM_CACHE_DIR``, else ``<tmp>/data-gym-cache``; an empty value
turns the cache off. A URL that is not in the cache is fetched with
``requests`` (``blobfile`` for other schemes), imported only then.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import tempfile
import uuid

_CACHE_ENV_VARS = ("TIKTOKEN_TPU_CACHE_DIR", "TIKTOKEN_CACHE_DIR", "DATA_GYM_CACHE_DIR")


def read_file(blobpath: str) -> bytes:
    """Read a local path, an http(s) URL, or (through blobfile) a blob URL."""
    if "://" not in blobpath:
        with open(blobpath, "rb", buffering=0) as f:
            return f.read()

    if blobpath.startswith(("http://", "https://")):
        # requests rather than blobfile for public files: no auth prompts
        import requests

        resp = requests.get(blobpath)
        resp.raise_for_status()
        return resp.content

    try:
        import blobfile
    except ImportError as e:
        raise ImportError(
            "blobfile is not installed. Please install it by running `pip install blobfile`."
        ) from e
    return blobfile.read_bytes(blobpath)


def check_hash(data: bytes, expected_hash: str) -> bool:
    return hashlib.sha256(data).hexdigest() == expected_hash


class _VocabCache:
    """A file cache keyed by sha1(path or URL), contents checked by sha256."""

    def __init__(self) -> None:
        self.dir: str | None = None
        self.user_specified = False
        for var in _CACHE_ENV_VARS:
            if var in os.environ:
                self.dir = os.environ[var] or None  # an empty value: no cache
                self.user_specified = True
                return
        self.dir = os.path.join(tempfile.gettempdir(), "data-gym-cache")

    def path_for(self, blobpath: str) -> str:
        assert self.dir is not None
        return os.path.join(self.dir, hashlib.sha1(blobpath.encode()).hexdigest())

    def lookup(self, blobpath: str, expected_hash: str | None) -> bytes | None:
        path = self.path_for(blobpath)
        if not os.path.exists(path):
            return None
        with open(path, "rb", buffering=0) as f:
            data = f.read()
        if expected_hash is None or check_hash(data, expected_hash):
            return data
        # a stale or corrupt entry: evicted, so that it is fetched again
        try:
            os.remove(path)
        except OSError:
            pass
        return None

    def store(self, blobpath: str, contents: bytes) -> None:
        try:
            assert self.dir is not None
            os.makedirs(self.dir, exist_ok=True)
            target = self.path_for(blobpath)
            tmp = f"{target}.{uuid.uuid4()}.tmp"
            with open(tmp, "wb") as f:
                f.write(contents)
            os.rename(tmp, target)  # atomic publish
        except OSError:
            # a read-only default cache is fine; a cache the user named is not
            if self.user_specified:
                raise


def read_file_cached(blobpath: str, expected_hash: str | None = None) -> bytes:
    cache = _VocabCache()
    if cache.dir is None:
        return read_file(blobpath)

    cached = cache.lookup(blobpath, expected_hash)
    if cached is not None:
        return cached

    contents = read_file(blobpath)
    if expected_hash and not check_hash(contents, expected_hash):
        raise ValueError(
            f"Hash mismatch for data downloaded from {blobpath} (expected {expected_hash}). "
            f"This may indicate a corrupted download. Please try again."
        )
    cache.store(blobpath, contents)
    return contents


def load_tiktoken_bpe(tiktoken_bpe_file: str, expected_hash: str | None = None
                      ) -> dict[bytes, int]:
    """Parse the ``.tiktoken`` format: ``base64(token) <space> rank`` lines."""
    contents = read_file_cached(tiktoken_bpe_file, expected_hash)
    ranks: dict[bytes, int] = {}
    for line in contents.splitlines():
        if not line:
            continue
        try:
            token_b64, rank_str = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank_str)
        except Exception as e:
            raise ValueError(f"Error parsing line {line!r} in {tiktoken_bpe_file}") from e
    return ranks


def dump_tiktoken_bpe(bpe_ranks: dict[bytes, int], tiktoken_bpe_file: str) -> None:
    """Write ranks in the ``.tiktoken`` format, sorted by rank: a local path
    with the standard library, a blob URL through blobfile."""
    lines = [
        base64.b64encode(token) + b" " + str(rank).encode() + b"\n"
        for token, rank in sorted(bpe_ranks.items(), key=lambda kv: kv[1])
    ]
    if "://" not in tiktoken_bpe_file:
        with open(tiktoken_bpe_file, "wb") as f:
            f.writelines(lines)
        return
    try:
        import blobfile
    except ImportError as e:
        raise ImportError(
            "blobfile is not installed. Please install it by running `pip install blobfile`."
        ) from e
    with blobfile.BlobFile(tiktoken_bpe_file, "wb") as f:
        f.writelines(lines)


def _data_gym_byte_remap() -> dict[str, int]:
    """GPT-2's printable-character remap: printable bytes other than the
    space map to themselves; the rest take chr(256 + n) in byte order."""
    remap = {chr(b): b for b in range(256) if chr(b).isprintable() and chr(b) != " "}
    gap = 0
    for b in range(256):
        if not (chr(b).isprintable() and chr(b) != " "):
            remap[chr(256 + gap)] = b
            gap += 1
    assert len(remap) == 256
    return remap


def data_gym_to_mergeable_bpe_ranks(
    vocab_bpe_file: str,
    encoder_json_file: str,
    vocab_bpe_hash: str | None = None,
    encoder_json_hash: str | None = None,
    clobber_one_byte_tokens: bool = False,
) -> dict[bytes, int]:
    """The rank table of GPT-2's vocab.bpe merge list and encoder.json.

    The single bytes take ranks 0..255 in remap order (printable bytes
    first), the merges follow in file order; the result must equal
    encoder.json, since rank order is merge priority."""
    remap = _data_gym_byte_remap()

    def decode_data_gym(value: str) -> bytes:
        return bytes(remap[ch] for ch in value)

    bpe_ranks: dict[bytes, int] = {bytes([b]): i for i, b in enumerate(remap.values())}

    vocab_bpe_contents = read_file_cached(vocab_bpe_file, vocab_bpe_hash).decode()
    # the first line is a version header; the last element after the split is empty
    for merge_str in vocab_bpe_contents.split("\n")[1:-1]:
        first, second = merge_str.split()
        bpe_ranks[decode_data_gym(first) + decode_data_gym(second)] = len(bpe_ranks)

    encoder_json = json.loads(read_file_cached(encoder_json_file, encoder_json_hash))
    encoder_json_loaded = {decode_data_gym(k): v for k, v in encoder_json.items()}
    # special tokens, not mergeable tokens
    encoder_json_loaded.pop(b"<|endoftext|>", None)
    encoder_json_loaded.pop(b"<|startoftext|>", None)

    if clobber_one_byte_tokens:
        for k, v in encoder_json_loaded.items():
            if len(k) == 1:
                bpe_ranks[k] = v

    assert bpe_ranks == encoder_json_loaded

    return bpe_ranks
