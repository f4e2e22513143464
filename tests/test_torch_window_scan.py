"""PyTorch port: the byte-level scanners (B9, B11, B12).

The byte-level ``compile_pattern`` gives the JAX package's arrays; the
plain ``seq_scan``, ``window_scan`` and ``orbit`` (the CPU paths of the
``byte_scan`` kernel) equal the jitted JAX functions on XLA:CPU and the
numpy specs, on the same rows cut by the port's ``pack_documents``.
Integers, so equality is exact. Where ``window_scan`` trips its u_cap,
every position is unresolved in both; the hop there is compared with the
single-sweep numpy spec, since the JAX hop of positions past the first
u_cap unresolved ones keeps its first-phase value."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_mixed_corpus, pat_str

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。"
K, LOOK, W = 64, 16, 48
KL = K + LOOK


@pytest.fixture(scope="module")
def dfas():
    from tiktoken_tpu.ops.regex_compiler import compile_pattern as jcompile

    from tiktoken_tpu_torch.ops.regex_compiler import compile_pattern

    return {name: (jcompile(pat_str(name)), compile_pattern(pat_str(name)))
            for name in ("o200k", "cl100k")}


@pytest.mark.parametrize("name", ["o200k", "cl100k"])
def test_byte_compile_pattern_matches_jax(dfas, name):
    jd, pd = dfas[name]
    for f in ("trans", "accept", "class_of"):
        a, b = getattr(jd, f), getattr(pd, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pd.n_states, pd.n_classes) == (jd.n_states, jd.n_classes)
    from tiktoken_tpu_torch.ops.regex_compiler import scan_bytes

    text = make_mixed_corpus(3000, seed=4).encode() + CJK.encode()
    from tiktoken_tpu.ops.regex_compiler import scan_bytes as jscan

    assert scan_bytes(pd, text) == jscan(jd, text)


def _rows(texts, n_rows: int):
    from tiktoken_tpu_torch.ops.engine import pack_documents

    b = pack_documents([t if isinstance(t, bytes) else t.encode() for t in texts], K)
    rows = np.zeros((n_rows, KL), np.uint8)
    pay = np.zeros(n_rows, np.int32)
    tot = np.zeros(n_rows, np.int32)
    n = min(n_rows, b.rows.shape[0])
    rows[:n], pay[:n], tot[:n] = b.rows[:n], b.n_payload[:n], b.n_total[:n]
    return rows, pay, tot


def _table(dfa):
    from tiktoken_tpu_torch.ops.window_scan import byte_scan_table

    return byte_scan_table(dfa)


TEXTS = {
    "mixed": [make_mixed_corpus(1500, seed=s) for s in range(2)],
    "edges": ["a\n b", "today\n \n", "x" * 200, "0" * 90, CJK * 3, b"ok \xff\xfe bytes",
              "🌍🌍🌍 emoji soup 🚀", "don't you're it's", ""],
}


@pytest.mark.parametrize("corpus", ["mixed", "edges"])
def test_seq_scan_matches_jax_and_numpy(dfas, corpus):
    from tiktoken_tpu.ops.window_scan import make_seq_scan_fn

    from tiktoken_tpu_torch.ops.window_scan import byte_class_grid, seq_scan, seq_scan_numpy

    dfa = dfas["o200k"][1]
    packed = _table(dfa)
    rows, pay, tot = _rows(TEXTS[corpus], 32)
    cls = byte_class_grid(torch.from_numpy(rows), torch.from_numpy(tot), KL + 1)
    ps, bad = seq_scan(torch.from_numpy(packed), torch.from_numpy(rows), torch.from_numpy(pay),
                       torch.from_numpy(tot), K=K)
    jps, jbad = (np.asarray(x) for x in jax.jit(make_seq_scan_fn(KL, K, 257, 256))(
        packed, cls.numpy(), pay, tot))
    np.testing.assert_array_equal(ps.numpy(), jps)
    np.testing.assert_array_equal(bad.numpy(), jbad)
    for b in range(rows.shape[0]):
        m, nb = seq_scan_numpy(dfa, packed, cls.numpy()[b], pay[b], tot[b], K)
        np.testing.assert_array_equal(ps.numpy()[b], m)
        assert bool(bad[b]) == nb
    if corpus == "edges":
        assert bad.any()  # the stray bytes make no progress


@pytest.mark.parametrize("case", ["mixed", "u_cap_overflow"])
def test_window_scan_matches_jax_and_numpy(dfas, case):
    from tiktoken_tpu.ops.window_scan import make_window_scan_fn

    from tiktoken_tpu_torch.ops.window_scan import byte_class_grid, match_ends_numpy, window_scan

    dfa = dfas["o200k"][1]
    packed = _table(dfa)
    texts = TEXTS["mixed"] + TEXTS["edges"] if case == "mixed" else ["x" * 1000]
    rows, _pay, tot = _rows(texts, 8)
    cls = byte_class_grid(torch.from_numpy(rows), torch.from_numpy(tot), K + W)
    hop, unres = (x.numpy() for x in window_scan(torch.from_numpy(packed), torch.from_numpy(rows),
                                                 torch.from_numpy(tot), K=K, window=W))
    jhop, junres = (np.asarray(x) for x in jax.jit(make_window_scan_fn(W, dfa.n_states, 257))(
        packed, cls.numpy()))
    np.testing.assert_array_equal(unres, junres)
    overflow = case == "u_cap_overflow"
    assert unres.all() == overflow
    if not overflow:
        np.testing.assert_array_equal(hop, jhop)
    for b in range(rows.shape[0]):
        # the numpy spec runs to the end of the grid row, EOF after it
        nh, nu = match_ends_numpy(dfa, dfa.class_of[cls.numpy()[b]].astype(np.int64), W)
        np.testing.assert_array_equal(hop[b], nh[:K])
        if not overflow:
            np.testing.assert_array_equal(unres[b], nu[:K])


def test_orbit_matches_jax(dfas):
    from tiktoken_tpu.ops.window_scan import make_orbit_fn

    from tiktoken_tpu_torch.ops.window_scan import orbit, window_scan

    dfa = dfas["o200k"][1]
    packed = _table(dfa)
    rows, pay, tot = _rows(TEXTS["mixed"] + TEXTS["edges"], 24)
    hop, unres = window_scan(torch.from_numpy(packed), torch.from_numpy(rows),
                             torch.from_numpy(tot), K=K, window=W)
    # plus random hops: zeros and long jumps end chains, some rows empty
    rng = np.random.default_rng(5)
    rhop = rng.integers(-1, 9, (8, K)).astype(np.int32)
    runres = rng.random((8, K)) < 0.05
    rlen = rng.integers(0, K + 1, 8).astype(np.int32)
    fn = jax.jit(make_orbit_fn(K))
    for h, u, v in ((hop.numpy(), unres.numpy(), pay), (rhop, runres, rlen)):
        ps, bad = (x.numpy() for x in orbit(torch.from_numpy(h), torch.from_numpy(u),
                                           torch.from_numpy(v)))
        jps = np.asarray(fn(h, v))
        np.testing.assert_array_equal(ps, jps)
        # the JAX v1 program's row flags (ops/engine.py build_pipeline_fn)
        np.testing.assert_array_equal(bad, (jps & (u | (h <= 0))).any(axis=1))


@pytest.mark.parametrize("name", ["r50k", "cl100k", "o200k"])
def test_hot_table_scans_equal_byte_table(dfas, name):
    """The renumbered table the kernels read (its ASCII states first) gives
    the plain scans' and the numpy spec's outputs of ``byte_scan_table``, on
    bench-corpus rows and the edge documents; its first H states are closed
    under ASCII bytes, with DEAD and START kept at 0 and 1."""
    from chip_smoke import make_bench_corpus
    from tiktoken_tpu_torch.ops.regex_compiler import compile_pattern
    from tiktoken_tpu_torch.ops.window_scan import (
        ACC_BITS, byte_class_grid, byte_scan_table, hot_byte_scan_table, seq_scan_numpy,
        seq_walk, window_scan)

    dfa = dfas[name][1] if name in dfas else compile_pattern(pat_str(name))
    plain = byte_scan_table(dfa)
    hot, H = hot_byte_scan_table(dfa)
    assert hot.shape == plain.shape and hot.dtype == np.int32 and 2 < H < hot.shape[0]
    nxt = hot >> ACC_BITS
    assert (nxt[:H, :128] < H).all(), "the first H states are closed under ASCII bytes"
    assert (nxt[1:H, :128] > 0).any() and (hot[0] >> ACC_BITS == 0).all()  # DEAD stays 0
    assert np.array_equal(np.sort(hot & ((1 << ACC_BITS) - 1), axis=None),
                          np.sort(plain & ((1 << ACC_BITS) - 1), axis=None))
    texts = [make_bench_corpus(1500, seed=7)] + TEXTS["edges"]
    rows, pay, tot = _rows(texts, 64)
    tr, tp, tt = (torch.from_numpy(x) for x in (rows, pay, tot))
    cls = byte_class_grid(tr, tt, KL + 1).numpy()
    got = seq_walk(torch.from_numpy(hot), tr, tp, tt, K=K)
    want = seq_walk(torch.from_numpy(plain), tr, tp, tt, K=K)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    for b in range(rows.shape[0]):
        m, nb = seq_scan_numpy(dfa, hot, cls[b], pay[b], tot[b], K)
        wm, wb = seq_scan_numpy(dfa, plain, cls[b], pay[b], tot[b], K)
        np.testing.assert_array_equal(m, wm)
        assert nb == wb == bool(got[1][b])
        np.testing.assert_array_equal(got[0][b].numpy(), m)
    for g, w in zip(window_scan(torch.from_numpy(hot), tr, tt, K=K, window=W),
                    window_scan(torch.from_numpy(plain), tr, tt, K=K, window=W), strict=True):
        assert torch.equal(g, w)
    assert got[1].any() and int(got[2].max()) > K  # bad rows; walks longer than a row


@pytest.mark.parametrize("k", [16, 48, 64])
def test_orbit_doubling_equals_the_orbit(k):
    """``make_orbit_doubling_fn`` (pointer doubling; nothing in the JAX
    package calls it) computes B12's function: it equals ``make_orbit_fn``
    and the port's ``orbit`` (``unresolved`` all False), whose kernel is
    ``tt_orbit``, on seeded hops with dead positions (hop <= 0), hops past
    the row, and ``valid_len`` 0, 1 and K."""
    from tiktoken_tpu.ops.window_scan import make_orbit_doubling_fn, make_orbit_fn

    from tiktoken_tpu_torch.ops.window_scan import orbit

    rng = np.random.default_rng(k)
    B = 64
    hop = rng.integers(1, 9, size=(B, k)).astype(np.int32)
    dead = rng.random((B, k)) < 0.08
    hop[dead] = rng.integers(-3, 1, size=int(dead.sum()))
    hop[:4] = rng.integers(1, k + 4, size=(4, k))
    valid_len = rng.integers(0, k + 1, size=B).astype(np.int32)
    valid_len[:3] = [0, 1, k]
    want = np.asarray(jax.jit(make_orbit_fn(k))(hop, valid_len))
    doubling = np.asarray(jax.jit(make_orbit_doubling_fn(k))(hop, valid_len))
    got, row_bad = orbit(torch.from_numpy(hop), torch.zeros((B, k), dtype=torch.bool),
                         torch.from_numpy(valid_len))
    np.testing.assert_array_equal(doubling, want)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(row_bad.numpy(), (want & (hop <= 0)).any(axis=1))
    np.testing.assert_array_equal(want[:, 0], valid_len > 0)
    assert row_bad.any() and not row_bad.all()  # some chains end at a dead position


FRONT_CASES = {  # case -> (texts, rows, window)
    "mixed": (["x" * 60 + " ok", "a\n b today\n \n"] + TEXTS["mixed"], 24, W),
    "u_cap_overflow": (["x" * 1000, "y " * 40, " " * 300], 16, W),
    "one_phase": (["x" * 60 + " ok", "a\n b today\n \n"] + TEXTS["mixed"], 24, 16),
}


def _front_case(dfas, case):
    from tiktoken_tpu_torch.ops.window_scan import window_orbit

    dfa = dfas["o200k"][1]
    packed = _table(dfa)
    texts, n_rows, window = FRONT_CASES[case]
    rows, pay, tot = _rows(texts, n_rows)
    ps, bad = (x.numpy() for x in window_orbit(
        torch.from_numpy(packed), torch.from_numpy(rows), torch.from_numpy(pay),
        torch.from_numpy(tot), K=K, window=window))
    return dfa, packed, rows, pay, tot, window, ps, bad


@pytest.mark.parametrize("case", list(FRONT_CASES))
def test_window_orbit_matches_jax(dfas, case):
    """B11-B12 as one function (the plain ``window_orbit``) against the JAX
    v1 front end: ``make_window_scan_fn``, ``make_orbit_fn`` and the row
    flags of ``build_pipeline_fn`` (``ops/engine.py:268-272``). Over u_cap
    every row with a payload is bad in both; there the JAX hop of positions
    past the first u_cap unresolved ones keeps its first-phase value, so
    the starts are held against JAX's orbit of the single-sweep numpy hops."""
    from tiktoken_tpu.ops.window_scan import make_orbit_fn, make_window_scan_fn

    from tiktoken_tpu_torch.ops.window_scan import byte_class_grid, match_ends_numpy

    dfa, packed, rows, pay, tot, window, ps, bad = _front_case(dfas, case)
    cls = byte_class_grid(torch.from_numpy(rows), torch.from_numpy(tot), K + window).numpy()
    jhop, junres = (np.asarray(x) for x in jax.jit(make_window_scan_fn(window, dfa.n_states, 257))(
        packed, cls))
    orbit_fn = jax.jit(make_orbit_fn(K))
    jps = np.asarray(orbit_fn(jhop, pay))
    np.testing.assert_array_equal(bad, (jps & (junres | (jhop <= 0))).any(axis=1))
    if case == "u_cap_overflow":
        assert junres.all() and (bad == (pay > 0)).all()
        hop = np.stack([match_ends_numpy(dfa, dfa.class_of[c].astype(np.int64), window)[0][:K]
                        for c in cls]).astype(np.int32)
        np.testing.assert_array_equal(ps, np.asarray(orbit_fn(hop, pay)))
    else:
        assert not junres.all() and bad.any() and not bad.all()
        np.testing.assert_array_equal(ps, jps)


def _fused_design(packed, rows, pay, tot, window, hot_rows=None):
    """A numpy emulation of tt_window_orbit's design: per row, every
    position walks at most FIRST_WINDOW bytes (hop and an "alive" bit);
    the orbit of 0 finishes the walk to ``window`` of a start still alive;
    the chunk's positions alive after FIRST_WINDOW bytes over u_cap make
    every row with a payload bad. -> (piece_start, row_bad, walk steps)."""
    from tiktoken_tpu_torch.ops.window_scan import ACC_BITS, DEAD, FIRST_WINDOW, START

    C, KL_ = rows.shape
    w1 = min(FIRST_WINDOW, window)
    steps = 0

    def walk(row, end, p, n):
        nonlocal steps
        state, hop = START, 0
        for o in range(n):
            q = p + o
            steps += 1
            v = int(packed[state, row[q] if q < end else 256])
            state = v >> ACC_BITS
            if state == DEAD:
                return hop, False
            a = (v & ((1 << ACC_BITS) - 1)) - 1
            if a >= 0:
                hop = o + 1 - a
        return hop, True

    ps = np.zeros((C, K), bool)
    bad = np.zeros(C, bool)
    n_alive = 0
    for r in range(C):
        end, vl = min(int(tot[r]), KL_), min(int(pay[r]), K)
        first = [walk(rows[r], end, p, w1) for p in range(K)]
        n_alive += sum(alive for _, alive in first)
        cur = 0
        while cur < vl:
            ps[r, cur] = True
            h, alive = first[cur]
            unresolved = False
            if alive:
                if w1 < window:
                    h, unresolved = walk(rows[r], end, cur, window)
                else:
                    unresolved = True
            bad[r] |= unresolved or h <= 0
            if h <= 0:
                break
            cur += h
    if w1 < window and n_alive > max(128, C * K // 32):
        bad = pay > 0
    return ps, bad, steps


@pytest.mark.parametrize("case", list(FRONT_CASES))
def test_fused_front_end_design_equals_plain(dfas, case):
    """The design of csrc/byte_scan.cu's tt_window_orbit (walks capped at 16
    bytes, the orbit finishing the rare longer match, the chunk-wide u_cap
    rule) gives the plain version's starts and row flags, and walks fewer
    bytes than the single-sweep window scan."""
    _, packed, rows, pay, tot, window, ps, bad = _front_case(dfas, case)
    got_ps, got_bad, steps = _fused_design(packed, rows, pay, tot, window)
    np.testing.assert_array_equal(got_ps, ps)
    np.testing.assert_array_equal(got_bad, bad)
    assert steps <= rows.shape[0] * K * window
