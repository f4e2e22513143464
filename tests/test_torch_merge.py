"""PyTorch port: the v1 full-grid merge (B13) and its row packing (B14).

The plain ``merge.merge`` and ``merge.pack_rows``, and ``merge.grid_merge``
(the CPU path of the ``grid_merge`` kernel, which merges each row's valid
prefix and packs it), against the JAX ``make_merge_fn`` on XLA:CPU, the
numpy spec ``merge_block_numpy`` and the sequential oracle
``byte_pair_encode``, on the same numpy inputs. Integers, so equality is
exact; ``tok`` is compared only where ``alive`` (the JAX kernel leaves
stale ids at dead positions, the port writes 0 there, which is also
checked)."""

from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_mixed_corpus, trained_ranks


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _port_merge(table, byte_vals, piece_start, valid):
    """B13 then B14 on any valid grid -> (tok, alive, packed, counts, rounds)."""
    from tiktoken_tpu_torch.ops.merge import merge, pack_rows

    tok, alive, rounds = merge(_i32(table.buckets), _i32(table.byte_to_rank),
                               torch.from_numpy(byte_vals), torch.from_numpy(piece_start),
                               torch.from_numpy(valid), table.seed)
    packed, counts = pack_rows(tok, alive)
    return tok, alive, packed, counts, rounds


def _grid_merge(table, rows, piece_start, n_payload):
    """What the v1 program runs: rows [C, KL] (the first K columns merged),
    each row valid below n_payload -> (packed, counts, rounds)."""
    from tiktoken_tpu_torch.ops.merge import grid_merge

    return grid_merge(_i32(table.buckets), _i32(table.byte_to_rank), torch.from_numpy(rows),
                      torch.from_numpy(piece_start), torch.from_numpy(n_payload), table.seed)


def _blocks(rng: np.random.Generator, data: bytes, B: int, K: int):
    """B rows of K bytes from ``data``, random piece starts (1 in 4) and
    random valid prefixes (some rows empty)."""
    src = np.frombuffer(data, np.uint8)
    offs = rng.integers(0, len(src) - K, B)
    byte_vals = np.stack([src[o : o + K] for o in offs])
    piece_start = rng.random((B, K)) < 0.25
    piece_start[:, 0] = True
    n_valid = rng.integers(0, K + 1, B)
    n_valid[0], n_valid[1] = K, 0
    valid = np.arange(K)[None, :] < n_valid[:, None]
    return byte_vals, piece_start & valid, valid, n_valid.astype(np.int32)


@pytest.mark.parametrize("B,K", [(6, 64), (3, 256)])
def test_grid_merge_matches_jax_and_numpy(B, K):
    from tiktoken_tpu.ops.engine import _cached_pair_table
    from tiktoken_tpu.ops.merge import make_merge_fn, merge_block_numpy

    from tiktoken_tpu_torch.ops.merge import merge_block_numpy as port_block

    table = _cached_pair_table(trained_ranks("o200k", 800))
    rng = np.random.default_rng(K)
    byte_vals, piece_start, valid, n_valid = _blocks(rng, make_mixed_corpus(6000, seed=3).encode(),
                                                     B, K)
    # a long single piece, so one row needs many rounds
    byte_vals[0, :] = ord("x")
    piece_start[0, 1:] = False

    fn = jax.jit(make_merge_fn(table.seed, table.n_buckets))
    jt, ja, jr = (np.asarray(x) for x in fn(table.buckets, table.byte_to_rank, byte_vals,
                                            piece_start, valid))
    tok, alive, packed, counts, rounds = (x.numpy() for x in
                                          _port_merge(table, byte_vals, piece_start, valid))
    np.testing.assert_array_equal(alive, ja)
    np.testing.assert_array_equal(tok.view(np.uint32)[ja], jt[ja])  # tok where alive only
    assert not tok[~alive].any()
    assert int(rounds) == int(jr)
    # B14: the JAX v1 assembly (alive tokens packed to the row front)
    np.testing.assert_array_equal(counts, ja.sum(1))
    for b in range(B):
        np.testing.assert_array_equal(packed[b].view(np.uint32)[: counts[b]], jt[b][ja[b]])
        assert not packed[b, counts[b]:].any()
        nt, na = merge_block_numpy(table, byte_vals[b], piece_start[b], valid[b])
        np.testing.assert_array_equal(na, ja[b])
        np.testing.assert_array_equal(nt[na], jt[b][ja[b]])
        pt, pa = port_block(table, byte_vals[b], piece_start[b], valid[b])
        np.testing.assert_array_equal(pa, na)
        np.testing.assert_array_equal(pt[pa], nt[na])
    # the v1 entry: rows wider than K (the lookahead columns are not merged)
    rows = np.concatenate([byte_vals, rng.integers(0, 256, (B, 16), dtype=np.uint8)], axis=1)
    gp, gc, gr = (x.numpy() for x in _grid_merge(table, rows, piece_start, n_valid))
    np.testing.assert_array_equal(gp, packed)
    np.testing.assert_array_equal(gc, counts)
    assert int(gr) == int(jr)


def _random_bpe_vocab(rng: random.Random, n_merges: int, alphabet: bytes) -> dict[bytes, int]:
    """Random vocab satisfying the BPE invariants: every merge concatenates
    two existing tokens; rank order == creation order."""
    ranks = {bytes([i]): i for i in range(256)}
    tokens = [bytes([b]) for b in alphabet]
    for _ in range(n_merges):
        for _attempt in range(50):
            cat = rng.choice(tokens) + rng.choice(tokens)
            if len(cat) <= 12 and cat not in ranks:
                ranks[cat] = len(ranks)
                tokens.append(cat)
                break
    return ranks


@pytest.mark.parametrize("seed", [1234, 99])
def test_random_vocab_fuzz(seed):
    """Random vocabularies, many pieces packed into rows: the port's
    lockstep rounds equal the sequential greedy oracle piece by piece."""
    from tiktoken_tpu_torch._pybpe import byte_pair_encode
    from tiktoken_tpu_torch.ops.pair_table import build_pair_table

    rng = random.Random(seed)
    K = 128
    for trial in range(12):
        alphabet = bytes(rng.sample(range(97, 105), rng.randrange(2, 5)))
        ranks = _random_bpe_vocab(rng, rng.randrange(5, 120), alphabet)
        table = build_pair_table(ranks)
        rows, starts, lens, want = [], [], [], []
        for _ in range(8):
            row, ps, w = b"", [], []
            while True:
                piece = bytes(rng.choice(alphabet) for _ in range(rng.randrange(1, 40)))
                if len(row) + len(piece) > K:
                    break
                ps.append(len(row))
                row += piece
                w.extend(byte_pair_encode(piece, ranks))
            bv = np.zeros(K, np.uint8)
            bv[: len(row)] = np.frombuffer(row, np.uint8)
            st = np.zeros(K, bool)
            st[ps] = True
            rows.append(bv)
            starts.append(st)
            lens.append(len(row))
            want.append(w)
        packed, counts, _r = _grid_merge(table, np.stack(rows), np.stack(starts),
                                         np.array(lens, np.int32))
        for b, w in enumerate(want):
            got = packed[b, : counts[b]].numpy().view(np.uint32).tolist()
            assert got == w, (trial, b)


def test_periodic_vocab_and_invalid_heads():
    """An engineered periodic vocabulary, and invalid positions inside a
    row (each its own segment head), against the numpy spec."""
    from tiktoken_tpu_torch._pybpe import byte_pair_encode
    from tiktoken_tpu_torch.ops.merge import merge_block_numpy
    from tiktoken_tpu_torch.ops.pair_table import build_pair_table

    ranks = {bytes([i]): i for i in range(256)}
    for tok in [b"xx", b"xxxx", b"xxx", b"ab", b"abab", b"ababab", b"abababab",
                b"xxxxxx", b"xxxxx", b"ba", b"baba", b"aba", b"bab"]:
        ranks[tok] = len(ranks)
    table = build_pair_table(ranks)
    data = b"x" * 37 + b"ab" * 11 + b"\0\0" + b"bababab" + b"abba" * 5
    K = len(data)
    bv = np.frombuffer(data, np.uint8).copy()[None, :]
    valid = np.ones((1, K), bool)
    valid[0, 59:61] = False
    ps = np.zeros((1, K), bool)
    ps[0, [0, 37, 61, 68]] = True
    tok, alive, packed, counts, _r = (x.numpy() for x in _port_merge(table, bv, ps, valid))
    nt, na = merge_block_numpy(table, bv[0], ps[0], valid[0])
    np.testing.assert_array_equal(alive[0], na)
    np.testing.assert_array_equal(tok[0].view(np.uint32)[na], nt[na])
    want = []
    for a, b in ((0, 37), (37, 59), (61, 68), (68, K)):
        want += byte_pair_encode(data[a:b], ranks)
    assert packed[0, : counts[0]].tolist() == want
