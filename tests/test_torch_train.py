"""PyTorch port: the pair-count training step and the host trainer.

The plain ``pair_hash`` against the JAX ``_pair_hash``; the port's
``corpus_pair_counts`` over 1-, 2- and 3-way CPU splits against the JAX
``corpus_pair_counts`` on the virtual CPU mesh (exact: hist, best_bin,
best_count); the first bin of a tie; the plain argmax against
``jnp.argmax`` on ``tt_hist_argmax``'s edge histograms, with the kernel's
block-key design in numpy; a two-process gloo all-reduce against
one process over all the rows; ``train_bpe`` against the JAX
``train_bpe``."""

from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_mixed_corpus, pat_str

RANK_ROWS = 7  # rows of the grid that rank 0 of the gloo test holds


def grid(seed: int = 0):
    """The shapes of ``tests/test_parallel.py``'s pair-count test (16 rows
    of 64, tokens < 500, 70% alive, 15% piece starts), plus an all-dead
    row, a row whose piece starts lie on dead columns only, and a row with
    large ids (>= 2^31) around dead stretches: 19 rows."""
    rng = np.random.default_rng(seed)
    B, K = 19, 64
    tokens = rng.integers(0, 500, size=(B, K)).astype(np.uint32)
    alive = rng.random((B, K)) < 0.7
    piece_start = rng.random((B, K)) < 0.15
    piece_start[:, 0] = True
    alive[16] = False
    alive[17] = np.arange(K) % 3 == 0
    piece_start[17] = ~alive[17]
    tokens[18] = rng.integers(2**31, 2**32, size=K, dtype=np.uint64).astype(np.uint32)
    alive[18] = np.arange(K) % 5 != 1
    return tokens, alive, piece_start


@pytest.mark.parametrize("bits", [12, 20])
def test_pair_hash_matches_jax(bits):
    from tiktoken_tpu.parallel.train import _pair_hash

    from tiktoken_tpu_torch.parallel.train import pair_hash

    rng = np.random.default_rng(bits)
    a = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 2**31, 2**32 - 1, 1]
    b[:4] = [2**32 - 1, 0, 2**31 + 5, 2**31]
    want = np.asarray(_pair_hash(jnp.asarray(a), jnp.asarray(b), bits))
    got = pair_hash(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)), bits)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("bits", [12, 20])
def test_corpus_pair_counts_matches_jax(n, bits):
    from tiktoken_tpu.parallel import corpus_pair_counts as jax_counts
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tiktoken_tpu_torch.parallel import corpus_pair_counts, data_mesh, pair_count_step

    tokens, alive, piece_start = grid()
    hist, best_bin, best_count = corpus_pair_counts(data_mesh(n, device="cpu"), tokens, alive,
                                                    piece_start, hist_bits=bits)
    w_hist, w_bin, w_count = jax_counts(jax_mesh(n), tokens, alive, piece_start, hist_bits=bits)
    assert hist.dtype == np.int32
    np.testing.assert_array_equal(hist, w_hist)
    assert (best_bin, best_count) == (w_bin, w_count)
    # the per-shard step on the whole grid, and the dead rows' share
    s_hist, s_bin, s_count = pair_count_step(
        *(torch.from_numpy(x) for x in (tokens.view(np.int32), alive, piece_start)),
        hist_bits=bits)
    np.testing.assert_array_equal(s_hist.numpy(), hist)
    assert (int(s_bin), int(s_count)) == (best_bin, best_count)
    # an all-dead row counts nothing; piece starts on dead columns between
    # two alive ones do not split their pair (only nxt's flag is read)
    for row, want_pairs in ((16, 0), (17, int(alive[17].sum()) - 1)):
        part = corpus_pair_counts(data_mesh(n, device="cpu"), tokens[row : row + 1],
                                  alive[row : row + 1], piece_start[row : row + 1],
                                  hist_bits=bits)
        assert part[0].sum() == want_pairs


def test_tie_takes_the_first_bin():
    from tiktoken_tpu_torch.ops.pair_count import hist_argmax

    for h in ([0, 3, 1, 3], [5, 5, 5], [0, 0, 0, 0], [1, 2, 7, 0, 7, 7]):
        best_bin, best_count = hist_argmax(torch.tensor(h, dtype=torch.int32))
        assert int(best_bin) == int(jnp.argmax(jnp.asarray(h, jnp.int32))) == h.index(max(h))
        assert int(best_count) == max(h)
    # two pairs with the same count: the smaller bin wins
    from tiktoken_tpu_torch.parallel import corpus_pair_counts, data_mesh

    tokens = np.asarray([[1, 2, 1, 2, 9, 8, 9, 8]], np.uint32)
    hist, best_bin, best_count = corpus_pair_counts(data_mesh(device="cpu"), tokens,
                                                    np.ones((1, 8), bool),
                                                    np.zeros((1, 8), bool), hist_bits=12)
    top = np.nonzero(hist == hist.max())[0]
    assert len(top) > 1 and best_bin == top[0] and best_count == hist.max()


def edge_hist(case: str, n: int) -> np.ndarray:
    """An edge histogram of ``tt_hist_argmax`` (``chip_smoke.argmax_edges``
    builds the same on the card): all zeros, the maximum tied at the first
    and the last bin, a tie spread over bins far apart (different blocks at
    2^20), one maximum of 2^31 - 1."""
    if case == "zeros":
        return np.zeros(n, np.int32)
    h = np.random.default_rng(n).integers(0, 50, n).astype(np.int32)
    if case == "ends":
        h[[0, -1]] = 99
    elif case == "spread":
        h[np.linspace(n // 7, n - 1, 5).astype(np.int64)] = 99
    else:
        h[n // 2] = np.iinfo(np.int32).max
    return h


def blocks_argmax(h: np.ndarray, blocks: int) -> tuple[int, int]:
    """The kernel's design in numpy: each bin's 64-bit key (the count with
    its sign bit flipped, then the inverted bin), the maximum key of each of
    ``blocks`` spans, then the maximum of those, decoded."""
    keys = (((h.view(np.uint32).astype(np.uint64) ^ np.uint64(0x80000000)) << np.uint64(32))
            | (~np.arange(len(h), dtype=np.uint32)).astype(np.uint64))
    best = max(int(part.max()) for part in np.array_split(keys, blocks) if len(part))
    count = np.uint32((best >> 32) ^ 0x80000000).view(np.int32)
    return (~best) & 0xFFFFFFFF, int(count)


@pytest.mark.parametrize("n", [1, 3, 4097, 1 << 20])
@pytest.mark.parametrize("case", ["zeros", "ends", "spread", "max_int"])
def test_hist_argmax_edges_match_jax(case, n):
    """The plain ``hist_argmax`` against ``jnp.argmax`` on the kernel's edge
    cases, whole and as an unaligned view (``base[1:]``), and the kernel's
    block-key design over 1, 7 and 256 blocks."""
    from tiktoken_tpu_torch.ops.pair_count import hist_argmax

    h = edge_hist(case, n)
    best = int(jnp.argmax(jnp.asarray(h)))
    want = (best, int(h[best]))
    base = torch.from_numpy(np.concatenate([[7], h]).astype(np.int32))
    for t in (torch.from_numpy(h), base[1:]):
        assert tuple(int(x) for x in hist_argmax(t)) == want
    for blocks in (1, 7, 256):
        assert blocks_argmax(h, blocks) == want


def _gloo_rank(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from tiktoken_tpu_torch.parallel import corpus_pair_counts, data_mesh

    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank,
                            world_size=2)
    try:
        tokens, alive, piece_start = grid()
        rows = slice(0, RANK_ROWS) if rank == 0 else slice(RANK_ROWS, None)
        hist, best_bin, best_count = corpus_pair_counts(
            data_mesh(2, device="cpu"), tokens[rows], alive[rows], piece_start[rows],
            hist_bits=12, group=dist.group.WORLD)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"),
                np.concatenate([hist, [best_bin, best_count]]))
    finally:
        dist.destroy_process_group()


def test_two_process_gloo_equals_one_process(tmp_path):
    import torch.multiprocessing as mp

    from tiktoken_tpu_torch.parallel import corpus_pair_counts, data_mesh

    ctx = mp.spawn(_gloo_rank, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=2,
                   join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the gloo ranks did not finish within 120 s")
    tokens, alive, piece_start = grid()
    hist, best_bin, best_count = corpus_pair_counts(data_mesh(device="cpu"), tokens, alive,
                                                    piece_start, hist_bits=12)
    want = np.concatenate([hist, [best_bin, best_count]])
    for rank in (0, 1):
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{rank}.npy"), want)


@pytest.mark.parametrize("pat", ["cl100k", "o200k"])
def test_train_bpe_matches_jax(pat):
    from tiktoken_tpu.train import train_bpe as jax_train

    from tiktoken_tpu_torch.train import train_bpe

    texts = [make_mixed_corpus(20000, seed=3), make_mixed_corpus(5000, seed=4)]
    got = train_bpe(texts, 400, pat_str(pat))
    assert len(got) == 400
    assert got == jax_train(texts, 400, pat_str(pat))


# ---------------------------------------------------------------------------
# the pair_count kernel's design (csrc/pair_count.cu)
# ---------------------------------------------------------------------------

KERNEL_TILE = 2048  # positions of a tile of scan_kernel


def tile_grid(seed: int = 5):
    """Rows longer than two kernel tiles: one row of a single repeated pair,
    rows alive only at a few columns (dead stretches across tile
    boundaries, and a dead row between alive ones), and a random row."""
    rng = np.random.default_rng(seed)
    B, K = 5, 2 * KERNEL_TILE + 300
    tokens = rng.integers(0, 5000, size=(B, K)).astype(np.uint32)
    alive = rng.random((B, K)) < 0.7
    piece_start = rng.random((B, K)) < 0.1
    piece_start[:, 0] = True
    tokens[0], alive[0], piece_start[0, 1:] = 7, True, False
    alive[1] = False
    alive[1, [3, KERNEL_TILE - 1, KERNEL_TILE + 1, K - 1]] = True
    alive[2] = False
    alive[3] = np.arange(K) % 3000 == 0
    return tokens, alive, piece_start


def _emulate_pair_hist(tokens, alive, piece_start, bits: int, tile: int) -> np.ndarray:
    """scan_kernel in numpy: tiles of the flat grid taken from its end, each
    publishing its first alive position (INC) or no alive one (AGG) and
    looking right for the first INC; a pair counts when the next alive
    position lies in the same row and does not start a piece; each pair
    adds one to its bin."""
    from tiktoken_tpu_torch.ops.pair_count import pair_hash

    B, K = tokens.shape
    N = B * K
    tok, al, ps = tokens.reshape(-1), alive.reshape(-1), piece_start.reshape(-1)
    n_tiles = -(-N // tile)
    status: dict[int, tuple] = {}
    hist = np.zeros(1 << bits, np.int64)
    for t in reversed(range(n_tiles)):
        f = np.arange(t * tile, min(N, (t + 1) * tile))
        idx = f[al[f]]
        status[t] = ("INC", int(idx[0])) if len(idx) else ("AGG",)
        nx = N
        for j in range(t + 1, n_tiles):
            if status[j][0] == "INC":
                nx = status[j][1]
                break
        if not len(idx):
            status[t] = ("INC", nx)
        nxt = np.append(idx[1:], nx)
        ok = nxt < (idx // K + 1) * K
        ok[ok] &= ~ps[nxt[ok]]
        bins = pair_hash(torch.from_numpy(tok[idx[ok]].view(np.int32)),
                         torch.from_numpy(tok[nxt[ok]].view(np.int32)), bits).numpy()
        np.add.at(hist, bins, 1)
    return hist.astype(np.int32)


@pytest.mark.parametrize("tile", [128, KERNEL_TILE])
@pytest.mark.parametrize("bits", [12, 20])
def test_pair_hist_tiles_match_jax(bits, tile):
    """``pair_hist`` and a numpy emulation of the kernel's design (tiles of
    ``tile`` positions) against the JAX ``per_shard`` on a grid longer than
    two kernel tiles: a hot bin, dead stretches across tile boundaries."""
    from tiktoken_tpu.parallel import corpus_pair_counts as jax_counts
    from tiktoken_tpu.parallel import data_mesh as jax_mesh

    from tiktoken_tpu_torch.ops.pair_count import pair_hist

    tokens, alive, piece_start = tile_grid()
    want = jax_counts(jax_mesh(1), tokens, alive, piece_start, hist_bits=bits)[0]
    got = pair_hist(*(torch.from_numpy(x) for x in (tokens.view(np.int32), alive, piece_start)),
                    bits)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_emulate_pair_hist(tokens, alive, piece_start, bits, tile), want)
    assert want.max() >= KERNEL_TILE  # the hot bin: row 0's repeated pair
