"""PyTorch port: each plain op (the CPU path of every kernel wrapper)
against the JAX function on XLA:CPU and against the numpy spec, on the
same seeded numpy inputs. All outputs are integers: exact equality."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_encoding, make_mixed_corpus, pat_str

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。春はあけぼの、やうやう白くなりゆく山際。"


@pytest.fixture(scope="module")
def char_tables():
    from tiktoken_tpu.ops.charclass import build_char_class_tables
    from tiktoken_tpu.ops.regex_compiler import compile_pattern_chars

    from tiktoken_tpu_torch.ops import charclass, regex_compiler, sweep_scan

    jt = build_char_class_tables(compile_pattern_chars(pat_str("o200k")))
    pt = charclass.build_char_class_tables(
        regex_compiler.compile_pattern_chars(pat_str("o200k")))
    st = sweep_scan.scan_tables(pt, sweep_scan.build_scan_consts(pt), torch.device("cpu"))
    return jt, pt, st


@pytest.fixture(scope="module")
def vocab_tables():
    eng = make_encoding("o200k", 800).device_engine
    return eng.pair_table, eng.vocab_table, eng.long_vocab_table


def _i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_mix_hashes_match_numpy():
    from tiktoken_tpu.ops.pair_table import _mix
    from tiktoken_tpu.ops.pieces import _mix_words, _mix_words16

    from tiktoken_tpu_torch.ops.pair_table import mix
    from tiktoken_tpu_torch.ops.pieces import mix_words

    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 500, dtype=np.uint64).astype(np.uint32)
    w16 = rng.integers(0, 2**32, (500, 16), dtype=np.uint64).astype(np.uint32)
    ln = rng.integers(0, 65, 500).astype(np.uint32)

    def t64(x):
        return torch.from_numpy(x.astype(np.int64))

    for seed in (0, 0x5EED0001, 0xFFFFFFFF):
        np.testing.assert_array_equal(mix(t64(a), t64(b), seed).numpy(), _mix(a, b, seed))
        np.testing.assert_array_equal(
            mix_words(t64(w16[:, :4]), t64(ln), seed).numpy(), _mix_words(w16[:, :4], ln, seed))
        np.testing.assert_array_equal(
            mix_words(t64(w16), t64(ln), seed).numpy(), _mix_words16(w16, ln, seed))


def _class_rows(seed, L):
    rng = np.random.default_rng(seed)
    corpus = (make_mixed_corpus(4000, seed=3) + CJK * 4).encode()
    rows, totals = [], []
    for _ in range(12):
        off = int(rng.integers(0, len(corpus) - L))
        rows.append(np.frombuffer(corpus[off : off + L], np.uint8).copy())
        totals.append(int(rng.integers(1, L + 1)))
    rows.append(np.frombuffer((CJK * 4).encode()[:L], np.uint8).copy())  # dense non-ASCII
    totals.append(L)
    rows.append(rng.integers(0, 256, L).astype(np.uint8))  # invalid UTF-8 soup
    totals.append(L)
    return np.stack(rows), np.asarray(totals, np.int32)


@pytest.mark.parametrize("na_frac", [2, 8])
def test_byte_classes_match_jax_and_numpy(char_tables, na_frac):
    from tiktoken_tpu.ops.charclass import make_byte_classes_fn, prepare_device_tables

    from tiktoken_tpu_torch.ops.charclass import byte_classes, byte_classes_numpy

    jt, pt, st = char_tables
    L = 96
    rows, totals = _class_rows(2, L)
    prep = prepare_device_tables(jt)
    want, want_over = jax.jit(make_byte_classes_fn(jt, na_frac=na_frac))(
        jnp.asarray(prep["page_planes"]), jnp.asarray(prep["mixed_t"]),
        jnp.asarray(rows), jnp.asarray(totals))
    got, over = byte_classes(st.page_entry, st.mixed_rows, torch.from_numpy(rows),
                             torch.from_numpy(totals), skip_class=st.skip_class,
                             cont_class=st.cont_class, eof_class=st.eof_class, na_frac=na_frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(over) == bool(want_over) == (na_frac == 8)  # the CJK row overflows 1/8
    if na_frac == 2:  # exact everywhere: equals the per-row spec
        for i in range(len(rows)):
            np.testing.assert_array_equal(
                got[i].numpy(), byte_classes_numpy(pt, rows[i], int(totals[i])), err_msg=str(i))


def _scan_inputs(pt, seed, K, KL, n=24):
    from tiktoken_tpu_torch.ops.charclass import byte_classes_numpy

    rng = np.random.default_rng(seed)
    corpus = (make_mixed_corpus(8000, seed=13) + CJK * 3 + "1" * 300).encode()
    cls, pays, tots, ends = [], [], [], []
    for _ in range(n):
        off = int(rng.integers(0, len(corpus) - KL))
        row = np.frombuffer(corpus[off : off + KL], np.uint8)
        t = int(rng.integers(0, KL + 1))
        cls.append(np.concatenate([byte_classes_numpy(pt, row, t), [pt.eof_class]]))
        pays.append(int(rng.integers(0, max(1, min(t, K)) + 1)))
        tots.append(t)
        ends.append(bool(rng.integers(0, 2)))
    return (np.stack(cls).astype(np.int32), np.asarray(pays, np.int32),
            np.asarray(tots, np.int32), np.asarray(ends, bool))


def test_handshake_scan_matches_jax_and_numpy(char_tables):
    from tiktoken_tpu.ops.sweep_scan import make_char_scan_fn

    from tiktoken_tpu_torch.ops.sweep_scan import handshake_scan, handshake_scan_numpy

    jt, pt, st = char_tables
    K, KL = 48, 88
    cls, pays, tots, ends = _scan_inputs(pt, 9, K, KL)
    jm, jf, jb = jax.jit(make_char_scan_fn(jt, KL, K, handshake=True))(
        jnp.asarray(cls), jnp.asarray(pays), jnp.asarray(tots), jnp.asarray(ends))
    m, f, b = handshake_scan(st.consts, torch.from_numpy(cls), torch.from_numpy(pays),
                             torch.from_numpy(tots), torch.from_numpy(ends), KP=K,
                             cont_class=st.cont_class, eof_class=st.eof_class)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert b.any() and (~b).any()
    for i in range(len(pays)):
        wm, wf, wb = handshake_scan_numpy(pt, cls[i], int(pays[i]), int(tots[i]),
                                          bool(ends[i]), K)
        assert bool(b[i]) == wb, i
        np.testing.assert_array_equal(m[i].numpy(), wm, err_msg=str(i))
        if not wb:  # a bad row's spec_f is unspecified by the spec
            assert int(f[i]) == wf, i


@pytest.mark.parametrize("corpus_kind", ["mixed", "cjk", "digits"])
def test_handshake_chain_reconstructs_document(char_tables, corpus_kind):
    """Speculative-handoff invariant on the plain scan: rows cut at char
    boundaries chain their [g, spec_f) segments into exactly the
    document's piece starts, or flag bad (only phase-locked digit runs)."""
    from tiktoken_tpu_torch._pybpe import HostBPE
    from tiktoken_tpu_torch.ops.charclass import byte_classes_numpy
    from tiktoken_tpu_torch.ops.sweep_scan import handshake_scan

    jt, pt, st = char_tables
    text = {"mixed": make_mixed_corpus(1200, seed=11), "cjk": CJK * 6,
            "digits": "12345678901234567890" * 40}[corpus_kind]
    data = text.encode()
    pieces = HostBPE({}, {}, pat_str("o200k")).split(text)
    true_bounds, pos = [], 0
    for p in pieces:
        true_bounds.append(pos)
        pos += len(p.encode())
    K, KL = 96, 176
    cuts = [0]
    while cuts[-1] < len(data):
        c = min(cuts[-1] + K, len(data))
        while c < len(data) and data[c] & 0xC0 == 0x80:
            c -= 1
        cuts.append(c)
    cls, pays, tots, ends = [], [], [], []
    for r in range(len(cuts) - 1):
        o = cuts[r]
        row = np.zeros(KL, np.uint8)
        t = min(len(data) - o, KL)
        row[:t] = np.frombuffer(data[o : o + t], np.uint8)
        cls.append(np.concatenate([byte_classes_numpy(pt, row, t), [pt.eof_class]]))
        pays.append(cuts[r + 1] - o)
        tots.append(t)
        ends.append(o + t == len(data))
    m, f, b = handshake_scan(
        st.consts, torch.from_numpy(np.stack(cls).astype(np.int32)),
        torch.tensor(pays, dtype=torch.int32), torch.tensor(tots, dtype=torch.int32),
        torch.tensor(ends), KP=K, cont_class=st.cont_class, eof_class=st.eof_class)
    got, prev_f, bad = [], 0, False
    for r in range(len(pays)):
        g = 0 if r == 0 else prev_f - cuts[r]
        if bool(b[r]) or not (g == pays[r] or bool(m[r, g])):
            bad = True
            break
        got.extend(cuts[r] + j for j in np.nonzero(m[r].numpy())[0] if j >= g)
        prev_f = cuts[r] + int(f[r])
    if bad:
        assert corpus_kind == "digits"
    else:
        assert prev_f == len(data) and got == true_bounds


def test_compact_matches_jax_and_numpy():
    from tiktoken_tpu.ops.compaction import compact as jcompact

    from tiktoken_tpu_torch.ops.compaction import (
        compact, compact_numpy, compact_rows, compact_slots)

    rng = np.random.default_rng(5)
    for n, p, out_size in ((300, 0.3, 120), (300, 0.6, 120), (64, 0.5, 100)):
        valid = rng.random(n) < p
        pays = [rng.integers(-2**31, 2**31, n).astype(np.int32) for _ in range(3)]
        (wo, wc), (jo, jc) = compact_numpy(valid, pays, out_size), jcompact(
            jnp.asarray(valid), [jnp.asarray(x) for x in pays], out_size)
        go, gc = compact(torch.from_numpy(valid), [torch.from_numpy(x) for x in pays], out_size)
        assert int(gc) == int(jc) == int(wc)
        for g, j, w in zip(go, jo, wo):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
            np.testing.assert_array_equal(g.numpy(), w)
        # with [n, w] payloads and each entry's slot, as the chunk program uses it
        wide = rng.integers(-2**31, 2**31, (n, 4)).astype(np.int32)
        (so, sw), sc, slot = compact_slots(
            torch.from_numpy(valid), [torch.from_numpy(pays[0]), torch.from_numpy(wide)], out_size)
        assert int(sc) == int(wc)
        np.testing.assert_array_equal(so.numpy(), wo[0])
        (ww,), _ = compact_numpy(np.broadcast_to(valid, wide.T.shape), [wide.T], out_size)
        np.testing.assert_array_equal(sw.numpy(), ww.T)
        want_slot = np.where(valid, np.cumsum(valid) - 1, -1)
        np.testing.assert_array_equal(slot.numpy(), want_slot)
    # row-wise, as the slot compactions use it
    valid = rng.random((40, 16)) < 0.4
    vals = rng.integers(0, 2**31, (40, 16)).astype(np.int32)
    (jo,), jc = jcompact(jnp.asarray(valid), [jnp.asarray(vals)], 16)
    got, cnt = compact_rows(torch.from_numpy(valid), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))


@pytest.mark.parametrize("m_cap, l_cap", [(64, 16), (8, 2)])  # roomy, and counts over the caps
def test_compact_kinds_matches_two_jax_compactions(m_cap, l_cap):
    from tiktoken_tpu.ops.compaction import compact as jcompact

    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.compaction import compact_kinds

    rng = np.random.default_rng(11)
    p, n_pieces = 300, 230
    lens = rng.integers(0, 80, p).astype(np.int32)
    lens[n_pieces:] = 0
    hit = np.where(rng.random(p) < 0.4, -1, rng.integers(0, 5000, p)).astype(np.int32)
    words = rng.integers(-2**31, 2**31, (p, 4)).astype(np.int32)
    starts = np.sort(rng.integers(0, 10**6, p)).astype(np.int32)
    live = np.arange(p) < n_pieces
    is_miss = live & (lens >= 2) & (lens <= 16) & (hit == -1)
    is_long = live & (lens > 16) & (lens <= 64)
    idx = np.arange(p, dtype=np.int32)
    args = [torch.from_numpy(x) for x in (words, starts, lens, hit)]
    got = compact_kinds(*args, torch.tensor(n_pieces, dtype=torch.int32), m_cap, l_cap)
    # the wrapper takes the plain version on CPU tensors
    got_k = kernels.compact_kinds(*args, torch.tensor(n_pieces, dtype=torch.int32), m_cap, l_cap)
    for a, b in zip(kernels_flat(got), kernels_flat(got_k), strict=True):
        assert torch.equal(a, b)
    (m_words, m_lens, m_pid), n_miss, mslot, (l_starts, l_lens, l_pid), n_long, lslot = got
    for mask, pays, cap, outs, count, slot in (
            (is_miss, [*words.T, lens, idx], m_cap, [*m_words.T, m_lens, m_pid], n_miss, mslot),
            (is_long, [starts, lens, idx], l_cap, [l_starts, l_lens, l_pid], n_long, lslot)):
        jo, jc = jcompact(jnp.asarray(mask), [jnp.asarray(np.ascontiguousarray(x)) for x in pays],
                          cap)
        assert int(count) == int(jc) == int(mask.sum())
        for g, j in zip(outs, jo, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        np.testing.assert_array_equal(slot.numpy(), np.where(mask, np.cumsum(mask) - 1, -1))
    if m_cap == 8:
        assert int(n_miss) > m_cap and int(n_long) > l_cap


def kernels_flat(out):
    """The tensors of a nested tuple of outputs, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in kernels_flat(o)]


def test_route_and_expand_match_jax_and_numpy():
    """The expansion; the routes of the slot counts to their pieces are now
    ``piece_counts``' gathers (test_piece_counts_matches_select_glue)."""
    from tiktoken_tpu.ops.compaction import expand as jexpand

    from tiktoken_tpu_torch.ops.compaction import expand, expand_numpy

    rng = np.random.default_rng(6)
    n = 200
    for out_size in (400, 150):  # roomy and cropped
        counts = rng.integers(0, 5, n).astype(np.int32)
        counts[rng.random(n) < 0.3] = 0
        pay = rng.integers(-2**31, 2**31, n).astype(np.int32)
        (jp,), jk, jv, jt = jexpand(jnp.asarray(counts), [jnp.asarray(pay)], out_size)
        (wp,), wk, wv, wt = expand_numpy(counts, [pay], out_size)
        (gp,), gk, gv, gt = expand(torch.from_numpy(counts), [torch.from_numpy(pay)], out_size)
        assert int(gt) == int(jt) == wt
        np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(gv.numpy(), wv)
        v = gv.numpy()  # JAX leaves slots past the total unspecified
        np.testing.assert_array_equal(gp.numpy()[v], np.asarray(jp)[v])
        np.testing.assert_array_equal(gk.numpy()[v], np.asarray(jk)[v])
        np.testing.assert_array_equal(gp.numpy(), wp)
        np.testing.assert_array_equal(gk.numpy(), wk)


def test_catalog_matches_numpy_spec():
    from tiktoken_tpu_torch.ops.compaction import catalog

    rng = np.random.default_rng(7)
    C, KP, KL, p_cap = 6, 90, 120, 50
    rows = rng.integers(0, 256, (C, KL)).astype(np.uint8)
    mask = rng.random((C, KP)) < 0.12
    mask[2] = False
    mask[2, [3, 80]] = True  # a 77-byte piece flags row 2
    spec_f = np.array([max(np.nonzero(mask[r])[0], default=0) + 1 + r for r in range(C)],
                      np.int32)
    row_bad = np.zeros(C, bool)
    row_bad[4] = True
    for cap in (p_cap, 8):  # roomy and overflowing
        starts, words, lens, bad, n = catalog(
            torch.from_numpy(rows), torch.from_numpy(mask), torch.from_numpy(spec_f),
            torch.from_numpy(row_bad), cap)
        want = [(r, c) for r in range(C) for c in np.nonzero(mask[r])[0]]
        assert int(n) == len(want)
        k = min(len(want), cap)
        np.testing.assert_array_equal(starts.numpy()[:k], [r * KL + c for r, c in want[:k]])
        assert not starts.numpy()[k:].any() and not words.numpy()[k:].any()
        assert not lens.numpy()[k:].any()
        want_bad = row_bad.copy()
        for i, (r, c) in enumerate(want[:k]):
            nxt = [c2 for r2, c2 in want[i + 1 : k] if r2 == r]
            ln = (nxt[0] if nxt else spec_f[r]) - c
            assert lens.numpy()[i] == ln
            want_bad[r] |= ln > 64
            b = np.zeros(16, np.uint8)
            seg = rows[r, c : c + min(ln, 16)]
            b[: len(seg)] = seg
            np.testing.assert_array_equal(words.numpy()[i], b.view(np.int32))
        np.testing.assert_array_equal(bad.numpy(), want_bad)
        assert bad.numpy()[2] == (cap == p_cap)


def test_expand_tokens_matches_numpy_spec():
    from tiktoken_tpu_torch.ops.compaction import expand_numpy, expand_tokens

    rng = np.random.default_rng(8)
    n, m_cap, l_cap = 120, 20, 4
    m_tok = rng.integers(0, 2**31, (m_cap, 16)).astype(np.int32)
    l_tok = rng.integers(0, 2**31, (l_cap, 64)).astype(np.int32)
    single = rng.random(n) < 0.5
    counts = np.where(single, 1, rng.integers(0, 5, n)).astype(np.int32)
    base = np.where(rng.random(n) < 0.8, rng.integers(0, m_cap, n) * 16,
                    m_cap * 16 + rng.integers(0, l_cap, n) * 64)
    ids = rng.integers(0, 2**31, n)
    combo = np.where(single, ids | 0x80000000, base).astype(np.uint32).view(np.int32)
    unified = np.concatenate([m_tok.reshape(-1), l_tok.reshape(-1)])
    for out_size in (400, 60):  # roomy and cropped
        (e,), k, v, total = expand_numpy(counts, [combo], out_size)
        low = e & 0x7FFFFFFF
        want = np.where(e < 0, low, unified[np.minimum(low + k, unified.size - 1)])
        tok, got_total = expand_tokens(torch.from_numpy(counts), torch.from_numpy(combo),
                                       torch.from_numpy(m_tok), torch.from_numpy(l_tok), out_size)
        assert int(got_total) == total
        np.testing.assert_array_equal(tok.numpy(), np.where(v, want, 0))


def _piece_words(rng, enc, n):
    """Real pieces of a mixed corpus (hits and misses), 4 packed words."""
    text = make_mixed_corpus(3000, seed=int(rng.integers(1000)))
    pieces = [p.encode() for p in enc._core_bpe.regex.findall(text)]
    pieces = [p for p in pieces if 1 <= len(p) <= 16][:n]
    words = np.zeros((len(pieces), 16), np.uint8)
    lens = np.zeros(len(pieces), np.int32)
    for i, p in enumerate(pieces):
        words[i, : len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    lens[::7] = 0  # dead lanes
    return words.view(np.uint32), lens


def test_vocab_hits_match_jax_and_numpy(vocab_tables):
    from tiktoken_tpu.ops.pieces import (
        build_long_vocab_table,
        long_vocab_hit_numpy,
        make_long_vocab_hit_fn,
        make_vocab_hit_fn,
        vocab_hit_numpy,
    )

    from tiktoken_tpu_torch.ops.pieces import long_vocab_hit, vocab_hit

    _, vt, _ = vocab_tables
    enc = make_encoding("o200k", 800)
    words, lens = _piece_words(np.random.default_rng(8), enc, 300)
    want = np.asarray(make_vocab_hit_fn(vt.seed, vt.n_buckets)(
        jnp.asarray(vt.buckets), jnp.asarray(words), jnp.asarray(lens)))
    got = _u32(vocab_hit(_i32(vt.buckets), _i32(words), torch.from_numpy(lens), vt.seed))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vocab_hit_numpy(vt, words, lens))
    assert (got != 0xFFFFFFFF).any() and (got == 0xFFFFFFFF).any()

    ranks = {bytes([b]): b for b in range(256)}
    toks = [b"x" * n for n in range(17, 65)] + [b"throw" + b"y" * 30 + b"away"]
    for t in toks:
        ranks[t] = len(ranks)
    lvt = build_long_vocab_table(ranks)
    q = np.zeros((len(toks) + 3, 64), np.uint8)
    ql = np.zeros(len(toks) + 3, np.int32)
    for i, t in enumerate(toks):
        q[i, : len(t)] = np.frombuffer(t, np.uint8)
        ql[i] = len(t)
    q[-3, :20] = ord("z")  # not in the vocabulary
    ql[-3] = 20
    q[-2, :16] = ord("x")  # 16 bytes never hit the long table
    ql[-2] = 16
    want = np.asarray(make_long_vocab_hit_fn(lvt.seed, lvt.n_buckets)(
        jnp.asarray(lvt.buckets), jnp.asarray(q), jnp.asarray(ql)))
    got = _u32(long_vocab_hit(_i32(lvt.buckets), torch.from_numpy(q), torch.from_numpy(ql),
                              lvt.seed))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, long_vocab_hit_numpy(lvt, q, ql))
    assert list(got[: len(toks)]) == [256 + i for i in range(len(toks))]


@pytest.mark.parametrize("W", [16, 64])
def test_slot_merge_matches_jax_and_numpy(vocab_tables, W):
    from tiktoken_tpu.ops.slot_merge import make_slot_merge_fn

    from tiktoken_tpu_torch.ops.slot_merge import slot_merge, slot_merge_numpy

    pt, _, _ = vocab_tables
    rng = np.random.default_rng(10 + W)
    text = make_mixed_corpus(6000, seed=W).encode()
    M = 48
    slots = np.zeros((M, W), np.uint8)
    lens = rng.integers(0, W + 1, M).astype(np.int32)
    for i in range(M):
        off = int(rng.integers(0, len(text) - W))
        slots[i, : lens[i]] = np.frombuffer(text[off : off + lens[i]], np.uint8)
    # leftmost ties: one pair repeated across the slot
    a, b = next(iter(((k[0], k[1]) for k in make_encoding("o200k", 800)._mergeable_ranks
                      if len(k) == 2)))
    slots[0, :10] = [a, b] * 5
    lens[0] = 10
    slots[1, :9] = [a] * 9
    lens[1] = 9
    jt, ja, _ = jax.jit(make_slot_merge_fn(pt.seed, pt.n_buckets, W))(
        jnp.asarray(pt.buckets), jnp.asarray(pt.byte_to_rank), jnp.asarray(slots),
        jnp.asarray(lens))
    jt, ja = np.asarray(jt), np.asarray(ja)
    gt, ga = slot_merge(_i32(pt.buckets), _i32(pt.byte_to_rank), torch.from_numpy(slots),
                        torch.from_numpy(lens), pt.seed)
    gt, ga = _u32(gt), ga.numpy()
    wt, wa = slot_merge_numpy(pt, slots, lens)
    np.testing.assert_array_equal(ga, ja)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gt[ga], jt[ja])
    np.testing.assert_array_equal(gt, wt)
    assert (ga.sum(axis=1) < lens).any(), "some pieces must merge"


def _left_packed(tok: np.ndarray, alive: np.ndarray):
    """Each row's alive tokens left-packed (zero past the count), counts."""
    out = np.zeros_like(tok)
    cnt = alive.sum(axis=1).astype(np.int32)
    for m in range(tok.shape[0]):
        out[m, : cnt[m]] = tok[m][alive[m]]
    return out, cnt


@pytest.mark.parametrize("W", [16, 64])
def test_slot_merge_packed_matches_jax_left_packed(vocab_tables, W):
    """The fused merge: JAX's make_slot_merge_fn, then the row-wise
    left-pack of its alive lanes, over the slots below n_real; a long slot
    with a whole-piece hit is that one token."""
    from tiktoken_tpu.ops.slot_merge import make_slot_merge_fn

    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.slot_merge import slot_merge_packed

    pt, _, _ = vocab_tables
    rng = np.random.default_rng(20 + W)
    text = make_mixed_corpus(6000, seed=W + 1).encode()
    M, n_real = 56, 49
    slots = np.zeros((M, W), np.uint8)
    lens = rng.integers(0, W + 1, M).astype(np.int32)
    for i in range(M):
        off = int(rng.integers(0, len(text) - W))
        slots[i, : lens[i]] = np.frombuffer(text[off : off + lens[i]], np.uint8)
    # leftmost ties: one pair repeated across the slot
    a, b = next(iter(((k[0], k[1]) for k in make_encoding("o200k", 800)._mergeable_ranks
                      if len(k) == 2)))
    slots[0, :10], lens[0] = [a, b] * 5, 10
    slots[1, :9], lens[1] = [a] * 9, 9
    slots[2, :W], lens[2] = [a, b] * (W // 2), W  # a full slot
    hit = None
    L = lens.copy()
    if W == 64:
        hit = np.where(rng.random(M) < 0.3, rng.integers(0, 5000, M), -1).astype(np.int32)
        hit[:3] = -1
        L = np.where(hit != -1, 0, lens)
    jt, ja, _ = jax.jit(make_slot_merge_fn(pt.seed, pt.n_buckets, W))(
        jnp.asarray(pt.buckets), jnp.asarray(pt.byte_to_rank), jnp.asarray(slots),
        jnp.asarray(L))
    want_tok, want_cnt = _left_packed(np.asarray(jt), np.asarray(ja))
    if hit is not None:
        is_hit = hit != -1
        want_tok[is_hit, 0], want_cnt[is_hit] = hit[is_hit], 1
    args = (_i32(pt.buckets), _i32(pt.byte_to_rank), torch.from_numpy(slots),
            torch.from_numpy(lens), pt.seed, torch.tensor(n_real, dtype=torch.int32),
            None if hit is None else torch.from_numpy(hit))
    got_tok, got_cnt = slot_merge_packed(*args)
    kt, kc = kernels.slot_merge_packed(*args)  # the wrapper takes the plain version on the CPU
    assert torch.equal(kt, got_tok) and torch.equal(kc, got_cnt)
    got_tok, got_cnt = _u32(got_tok), got_cnt.numpy()
    np.testing.assert_array_equal(got_cnt[:n_real], want_cnt[:n_real])
    for m in range(n_real):
        np.testing.assert_array_equal(got_tok[m, : want_cnt[m]], want_tok[m, : want_cnt[m]],
                                      err_msg=f"slot {m}")
    assert (want_cnt[:n_real] < np.minimum(lens, W)[:n_real]).any(), "some pieces must merge"
    assert want_cnt[n_real:].any(), "slots past n_real must hold work that is left out"


def test_piece_counts_matches_select_glue():
    """piece_counts (the counts and combos that the assembly, tt_assemble,
    makes where it reads each piece) on a real v2 chunk's catalog (singles,
    short misses, long hits and long misses) equals the select glue it
    replaces: the slot counts routed to their pieces by piece index, then
    the selects."""
    import tiktoken_tpu_torch
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.compaction import piece_counts
    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import NA_FRAC, chunk_caps2

    ranks = dict(make_encoding("o200k", 800)._mergeable_ranks)
    long_words = [b"abcdefghijklmnopqrstu", b" internationalization", b"x" * 40]
    for w in long_words:
        ranks[w] = len(ranks)
    enc = tiktoken_tpu_torch.Encoding("counts", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                      special_tokens={})
    t = enc.engine("cpu").tables
    text = (make_mixed_corpus(1500, seed=3) + " abcdefghijklmnopqrstu internationalization "
            + "x" * 40 + " zyxwvutsrqponmlkjihgfedcba " + "q" * 50 + " a b")
    batch = pack_documents([text.encode()], 256)
    C = 8
    rows, pay, tot = (torch.from_numpy(np.ascontiguousarray(a[:C]))
                      for a in (batch.rows, batch.n_payload, batch.n_total))
    caps = chunk_caps2(256, C)
    p_cap, m_cap, l_cap = caps["p_cap"], caps["m_cap"], caps["l_cap"]
    ps, bad, _ = kernels.char_scan(t.scan, rows, pay, tot, K=256, na_frac=NA_FRAC)
    starts, words, lens, bad, n_pieces = kernels.catalog2(ps, pay, rows, bad, p_cap)
    hit = kernels.vocab_hit(t.vocab_buckets, words, torch.where(lens <= 16, lens, 0),
                            t.vocab_seed)
    (m_words, m_lens, m_pid), n_miss, mslot, (l_starts, l_lens, l_pid), n_long, lslot = \
        kernels.compact_kinds(words, starts, lens, hit, n_pieces, m_cap, l_cap)
    _, m_count = kernels.slot_merge_packed(t.pair_buckets, t.byte_to_rank,
                                           m_words.view(torch.uint8), m_lens, t.pair_seed, n_miss)
    l_bytes = kernels.extract_slots(rows, l_starts, l_lens, 256)
    l_hit = kernels.long_vocab_hit(t.long_buckets, l_bytes, l_lens, t.long_seed)
    _, l_count = kernels.slot_merge_packed(t.pair_buckets, t.byte_to_rank, l_bytes, l_lens,
                                           t.pair_seed, n_long, hit=l_hit)
    counts, combo = piece_counts(n_pieces, lens, hit, words, t.byte_to_rank, mslot, lslot,
                                 m_count, l_count)

    # the replaced glue: routes of the slot counts by piece index, then selects
    def route(pid, real, cnt):
        out = np.zeros(p_cap + 1, np.int64)
        out[np.where(real, pid, p_cap)] = np.where(real, cnt, 0)
        return out[:p_cap]

    ln, ht, ms, ls = (x.numpy().astype(np.int64) for x in (lens, hit, mslot, lslot))
    counts_m = route(m_pid.numpy(), np.arange(m_cap) < int(n_miss), m_count.numpy())
    counts_l = route(l_pid.numpy(), np.arange(l_cap) < int(n_long), l_count.numpy())
    single_tok = np.where(ln == 1, t.byte_to_rank.numpy()[words.numpy()[:, 0] & 0xFF], ht)
    is_single = (ln == 1) | ((ln >= 2) & (ln <= 16) & (ht != -1))
    want_counts = np.where(is_single, 1, np.where(ms >= 0, counts_m, np.where(ls >= 0, counts_l,
                                                                              0)))
    base = np.where(ms >= 0, np.clip(ms, 0, m_cap - 1) * 16,
                    np.where(ls >= 0, m_cap * 16 + np.clip(ls, 0, l_cap - 1) * 64, 0))
    want_combo = np.where(is_single, (single_tok | -0x80000000), base).astype(np.int32)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(combo.numpy(), want_combo)
    lh = l_hit.numpy()[: int(n_long)]
    assert int(n_miss) > 0 and is_single.any() and (lh != -1).any() and (lh == -1).any()


def test_wrappers_reject_non_cuda_devices():
    from tiktoken_tpu_torch.ops import kernels

    m = torch.empty((4, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.slot_merge_packed(m, m, m, m, 0, m)
