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


# ---------------------------------------------------------------------------
# the grid_merge kernel's design (csrc/grid_merge.cu), at K=256
# ---------------------------------------------------------------------------

BOUNDARY_LENGTHS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 63, 64, 65, 255, 256)
RANK_MAX = 0xFFFFFFFF


def _boundary_rows(seed: int = 7):
    """Rows of K=256 (KL=272), each cut into pieces of one length of
    BOUNDARY_LENGTHS (its last piece shorter): mixed text, runs of one
    letter, a periodic run, and rows of no or partial payload."""
    rng = np.random.default_rng(seed)
    K, KL = 256, 272
    text = np.frombuffer(make_mixed_corpus(60_000, seed=seed).encode(), np.uint8)
    rows, starts, pays = [], [], []
    for i, L in enumerate(BOUNDARY_LENGTHS):
        for kind in ("text", "run", "periodic"):
            o = int(rng.integers(0, len(text) - KL))
            row = text[o : o + KL].copy()
            if kind == "run":
                row[:] = ord("x")
            elif kind == "periodic":
                row[:] = np.frombuffer((b"ab" * KL)[:KL], np.uint8)
            ps = np.zeros(K, bool)
            ps[::L] = True
            rows.append(row)
            starts.append(ps)
            pays.append(K if kind != "periodic" or i % 3 else int(rng.integers(1, K)))
    rows.append(text[:KL].copy())
    starts.append(np.ones(K, bool))
    pays.append(0)  # no payload
    return np.stack(rows), np.stack(starts), np.asarray(pays, np.int32)


def _jax_v1(table, rows, piece_start, n_payload):
    """The JAX make_merge_fn on the rows' first K columns, then the v1
    assembly: (packed rows as lists, counts, rounds)."""
    from tiktoken_tpu.ops.merge import make_merge_fn

    K = piece_start.shape[1]
    valid = np.arange(K)[None, :] < n_payload[:, None]
    fn = jax.jit(make_merge_fn(table.seed, table.n_buckets))
    jt, ja, jr = (np.asarray(x) for x in fn(table.buckets, table.byte_to_rank,
                                            np.ascontiguousarray(rows[:, :K]),
                                            piece_start & valid, valid))
    return [jt[b][ja[b]].tolist() for b in range(len(rows))], ja.sum(1), int(jr)


def _periodic_ranks() -> dict[bytes, int]:
    """Bytes, then periodic tokens: pairs of a piece of repeats tie on rank."""
    ranks = {bytes([i]): i for i in range(256)}
    for tok in [b"xx", b"xxxx", b"xxx", b"ab", b"abab", b"ababab", b"abababab", b"xxxxxx",
                b"xxxxx", b"ba", b"baba", b"aba", b"bab", b"x" * 8, b"x" * 16, b"x" * 32]:
        ranks[tok] = len(ranks)
    return ranks


@pytest.mark.parametrize("vocab", ["trained", "periodic"])
def test_grid_merge_boundary_lengths_match_jax(vocab):
    """Pieces of every length-class boundary of the kernel, 1 to 256 bytes
    (a row that is one piece, long runs, a periodic vocabulary whose
    repeated pairs tie on rank), through the plain ``grid_merge``, against
    the JAX kernel with the v1 assembly and the numpy spec."""
    from tiktoken_tpu.ops.engine import _cached_pair_table

    ranks = trained_ranks("o200k", 800) if vocab == "trained" else _periodic_ranks()
    table = _cached_pair_table(ranks)
    rows, starts, pays = _boundary_rows()
    packed, counts, rounds = (x.numpy() for x in _grid_merge(table, rows, starts, pays))
    want, want_counts, want_rounds = _jax_v1(table, rows, starts, pays)
    np.testing.assert_array_equal(counts, want_counts)
    assert int(rounds) == want_rounds
    valid = np.arange(256)[None, :] < pays[:, None]
    for b, w in enumerate(want):
        assert packed[b, : counts[b]].view(np.uint32).tolist() == w, b
        assert not packed[b, counts[b]:].any()
        nt, na = merge_block_numpy_port(table, rows[b, :256], starts[b] & valid[b], valid[b])
        assert nt[na].tolist() == w, b


def merge_block_numpy_port(table, byte_vals, piece_start, valid):
    from tiktoken_tpu_torch.ops.merge import merge_block_numpy

    return merge_block_numpy(table, byte_vals, piece_start, valid)


# -- a numpy emulation of the kernel: piece list, lane groups, packing ----


def _class_of(L: int) -> int:
    return L - 1 if L <= 16 else 16 if L <= 64 else 17


def _width_of(c: int) -> int:
    return 8 if c < 8 else 16 if c < 16 else 64


def _piece_list(piece_start, n_payload):
    """list_kernel: each row walked right to left 32 columns at a time by
    ballot; every piece (flat head, length) under its length class."""
    C, K = piece_start.shape
    classes = [[] for _ in range(18)]
    for r in range(C):
        nv = min(max(int(n_payload[r]), 0), K)
        end = nv
        for c0 in range(((nv - 1) >> 5) << 5, -1, -32):
            heads = [k for k in range(c0, c0 + 32) if k < nv and (k == 0 or piece_start[r, k])]
            for k in heads:
                above = [h for h in heads if h > k]
                L = (above[0] if above else end) - k
                classes[_class_of(L)].append((r * K + k, L))
            if heads:
                end = heads[0]
    return classes


def _group_merge(table, toks, W: int, G: int) -> list[int]:
    """tt::group_merge: G lanes of P = W / G positions; the leftmost minimum
    by a minimum over each lane's positions, a minimum over the lanes, then
    the lowest position at it over the lanes; the alive positions as one
    mask."""
    from tiktoken_tpu_torch.ops.pair_table import lookup_numpy

    P = W // G
    L = len(toks)
    tok = [int(t) for t in toks] + [0] * (W - L)

    def probe(a, b):
        return int(lookup_numpy(table, np.asarray([a], np.uint32), np.asarray([b], np.uint32))[0])

    rank = [probe(tok[p], tok[p + 1]) if p + 1 < L else RANK_MAX for p in range(W)]
    alive = (1 << L) - 1
    while True:
        rmin = min(min(rank[t * P : t * P + P]) for t in range(G))
        if rmin == RANK_MAX:
            break
        firsts = [min([t * P + q for q in range(P) if rank[t * P + q] == rmin] or [0xFFFF])
                  for t in range(G)]
        k = min(firsts)
        above = [p for p in range(W) if alive >> p & 1 and p > k]
        j = above[0]
        alive &= ~(1 << j)
        jn = next((p for p in range(j + 1, W) if alive >> p & 1), -1)
        l_ = max((p for p in range(k) if alive >> p & 1), default=-1)
        rank[k] = probe(rmin, tok[jn]) if jn >= 0 else RANK_MAX
        rank[j] = RANK_MAX
        if l_ >= 0:
            rank[l_] = probe(tok[l_], rmin)
        tok[k] = rmin
    return [tok[p] for p in range(W) if alive >> p & 1]


def _long_merge(table, toks) -> list[int]:
    """long_kernel: one warp per piece over next / previous links."""
    from tiktoken_tpu_torch.ops.pair_table import lookup_numpy

    L = len(toks)
    tok = [int(t) for t in toks]
    nxt, prv = list(range(1, L + 1)), list(range(-1, L - 1))

    def probe(a, b):
        return int(lookup_numpy(table, np.asarray([a], np.uint32), np.asarray([b], np.uint32))[0])

    rank = [probe(tok[i], tok[i + 1]) if i + 1 < L else RANK_MAX for i in range(L)]
    while min(rank) != RANK_MAX:
        rmin = min(rank)
        k = rank.index(rmin)
        j = nxt[k]
        jn = nxt[j]
        l_ = prv[k] if k > 0 else -1
        rank[k] = probe(rmin, tok[jn]) if jn < L else RANK_MAX
        if l_ >= 0:
            rank[l_] = probe(tok[l_], rmin)
        tok[k], rank[j], tok[j] = rmin, RANK_MAX, RANK_MAX
        nxt[k] = jn
        if jn < L:
            prv[jn] = k
    return [t for t in tok if t != RANK_MAX]


def _emulate_grid_merge(table, rows, piece_start, n_payload):
    """The kernel's five passes in numpy -> (packed, counts, rounds)."""
    C, K = piece_start.shape
    tok = np.full(C * K, 0x5A5A5A5A, np.uint64)  # unwritten scratch
    most = 0
    for c, entries in enumerate(_piece_list(piece_start, n_payload)):
        for pos, L in entries:
            r, col = divmod(pos, K)
            toks = table.byte_to_rank[rows[r, col : col + L]]
            if c < 17:  # one lane up to 16 bytes, 8 lanes of 8 positions for 17-64
                W = _width_of(c)
                out = _group_merge(table, toks, W, 8 if W == 64 else 1)
            else:
                out = _long_merge(table, toks)
            tok[pos : pos + len(out)] = out
            if len(out) < L:
                tok[pos + len(out)] = RANK_MAX
            most = max(most, L - len(out))
    # pack_kernel: a column survives when no RANK_MAX lies between its
    # piece's head and it, by ballots over 32 columns
    packed = np.zeros((C, K), np.uint64)
    counts = np.zeros(C, np.int64)
    for r in range(C):
        nv = min(max(int(n_payload[r]), 0), K)
        out, dead_in = 0, False
        for c0 in range(0, nv, 32):
            lanes = range(32)
            ins = [c0 + i < nv for i in lanes]
            v = [int(tok[r * K + c0 + i]) if ins[i] else 0 for i in lanes]
            hm = sum(1 << i for i in lanes if ins[i] and (c0 + i == 0 or piece_start[r, c0 + i]))
            tm_all = sum(1 << i for i in lanes if ins[i] and v[i] == RANK_MAX)
            dead = []
            for i in lanes:
                upto = (2 << i) - 1
                hb, tm = hm & upto, tm_all & upto
                dead.append(tm >> (hb.bit_length() - 1) != 0 if hb else dead_in or tm != 0)
            for i in lanes:
                if ins[i] and not dead[i]:
                    packed[r, out] = v[i]
                    out += 1
            dead_in = dead[31]
        counts[r] = out
    return packed, counts, most


@pytest.mark.parametrize("seed", [2, 8, 16])
def test_kernel_design_emulation_matches_spec(seed):
    """The kernel's design in numpy (one lane a piece up to 16 bytes, 8
    lanes of 8 positions for 17-64, a warp for longer pieces), over the
    length-boundary rows (full 16- and 64-byte pieces among them) and
    random rows, equals the plain ``grid_merge``."""
    from tiktoken_tpu.ops.engine import _cached_pair_table

    table = _cached_pair_table(trained_ranks("o200k", 800))
    rows, starts, pays = _boundary_rows(seed=seed)
    keep = [i for i, L in enumerate(np.repeat(BOUNDARY_LENGTHS, 3)) if L in (1, 9, 16, 17, 64,
                                                                              65, 256)]
    rows, starts, pays = rows[keep], starts[keep], pays[keep]
    rng = np.random.default_rng(seed)
    b2, s2, _v, n2 = _blocks(rng, make_mixed_corpus(6000, seed=seed).encode(), 4, 256)
    rows = np.concatenate([rows, np.concatenate([b2, rows[:4, 256:]], axis=1)])
    starts, pays = np.concatenate([starts, s2]), np.concatenate([pays, n2])
    gp, gc, gr = (x.numpy() for x in _grid_merge(table, rows, starts, pays))
    ep, ec, er = _emulate_grid_merge(table, rows, starts, pays)
    np.testing.assert_array_equal(ec, gc)
    np.testing.assert_array_equal(ep.astype(np.uint32), gp.view(np.uint32))
    assert er == int(gr)
