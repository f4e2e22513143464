"""PyTorch port: the v3 chunk program (its CPU path, the kernels' plain
versions) against the JAX ``build_pipeline3_fn`` on the same
``chunk_inputs3`` arrays, in the normal and the worst-case variants:
``(flat_tok[:n_tokens], header)`` must be equal, overflowing chunks
included."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_encoding, make_mixed_corpus

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。春はあけぼの、やうやう白くなりゆく山際。"
CYR = "Широкая электрификация южных губерний даст мощный толчок подъёму сельского хозяйства. Съешь же ещё этих мягких французских булок, да выпей чаю! "
ARABIC = "أهلاً وسهلاً بكم في عالم البرمجة. النص العربي يمتد من اليمين إلى اليسار، وهذا اختبار للمحلل. "

K, C = 96, 8  # the geometry of tests/test_pipeline3.py
K_WIDE, C_WIDE = 176, 16


def _build(K_, C_, variants):
    """(the JAX v3 programs by worst_case variant, their table arguments,
    the port's tables, the flat size, the builder's keyword arguments)."""
    from tiktoken_tpu.ops import pipeline3 as J3
    from tiktoken_tpu.ops.charclass import prepare_device_tables

    from tiktoken_tpu_torch.convert import tables_from_numpy

    eng = make_encoding("o200k", 800).device_engine
    ct, pt, vt, lvt = eng.char_tables, eng.pair_table, eng.vocab_table, eng.long_vocab_table
    KP, KL = J3.row_geometry(K_)
    S = -(-(C_ * KP + KL + 8) // 128) * 128
    kw = dict(K=K_, C=C_, flat_size=S, char_tables=ct, pair_seed=pt.seed,
              pair_buckets=pt.n_buckets, vocab_seed=vt.seed, vocab_buckets=vt.n_buckets,
              long_seed=lvt.seed, long_buckets=lvt.n_buckets, pack24=False)
    fns = {wc: jax.jit(J3.build_pipeline3_fn(**kw, worst_case=wc)) for wc in variants}
    prep = prepare_device_tables(ct)
    targs = ((jnp.asarray(prep["page_planes"]), jnp.asarray(prep["mixed_t"])),
             jnp.asarray(pt.buckets), jnp.asarray(pt.byte_to_rank),
             (jnp.asarray(vt.buckets), jnp.asarray(lvt.buckets)))
    arrays = dict(page_entry=ct.page_entry, mixed_rows=ct.mixed_rows, trans=ct.trans,
                  accept=ct.accept, pair_buckets=pt.buckets, byte_to_rank=pt.byte_to_rank,
                  vocab_buckets=vt.buckets, long_buckets=lvt.buckets)
    meta = dict(n_classes=ct.n_classes, eof_class=ct.eof_class, n_states=ct.n_states,
                pair_seed=pt.seed, n_vocab=pt.n_vocab, vocab_seed=vt.seed,
                long_seed=lvt.seed)
    return fns, targs, tables_from_numpy(arrays, meta, device="cpu"), S, kw


@pytest.fixture(scope="module")
def setup():
    return _build(K, C, (False, True))


@pytest.fixture(scope="module")
def setup_wide():
    """A geometry whose piece cap (716) is over its short-miss cap (256)
    and equals its token cap, the normal variant only."""
    return _build(K_WIDE, C_WIDE, (False,))


def _compare(setup, texts, want_overflow=None, geometry=(K, C)):
    """Every chunk of ``texts`` through both programs in each variant of
    ``setup``; returns the normal variant's headers."""
    from tiktoken_tpu.ops import pipeline3 as J3

    from tiktoken_tpu_torch.ops import pipeline3 as P3

    fns, targs, tables, S, _ = setup
    K_, C_ = geometry
    docs = [t.encode() for t in texts]
    pc, pcp = J3.pack_corpus3(docs, K_), P3.pack_corpus3(docs, K_)
    for f in ("flat", "row_off", "n_payload", "n_total", "is_doc_end", "prev_same_doc",
              "doc_index"):
        np.testing.assert_array_equal(getattr(pcp, f), getattr(pc, f), err_msg=f)
    overflows, headers = [], []
    for wc in fns:
        for lo in range(0, len(pc.row_off), C_ - 1):
            inputs, _ = J3.chunk_inputs3(pc, lo, C_ - 1, C_, S)
            inputs_p, _ = P3.chunk_inputs3(pcp, lo, C_ - 1, C_, S)
            for a, b in zip(inputs, inputs_p):
                np.testing.assert_array_equal(a, b)
            jt, jh = (np.asarray(x) for x in fns[wc](*targs, *inputs))
            tt, th = P3.run_chunk(tables, *[torch.from_numpy(x) for x in inputs_p], K=K_,
                                  worst_case=wc)
            th, tt = th.numpy(), tt.numpy().view(np.uint32)
            assert th.shape == (2 * C_ + 5,)
            np.testing.assert_array_equal(th, jh, err_msg=f"header wc={wc} lo={lo}")
            nt = int(jh[-2])
            np.testing.assert_array_equal(tt[:nt], jt[:nt], err_msg=f"tokens wc={wc} lo={lo}")
            if wc:
                assert not th[-1], "the worst-case variant cannot overflow"
            else:
                overflows.append(bool(th[-1]))
                headers.append(th)
    if want_overflow is not None:
        assert any(overflows) == want_overflow
    return headers


def test_mixed_corpus(setup):
    _compare(setup, [make_mixed_corpus(2500, seed=s) for s in range(2)])


def test_cjk_cyrillic_arabic(setup):
    # dense non-ASCII rows overflow the normal variant's class cap
    _compare(setup, [CJK * 8, CYR * 6, ARABIC * 5], want_overflow=True)


def test_dense_pieces_take_the_worst_case(setup):
    _compare(setup, ["1a" * 600, "? " * 300], want_overflow=True)


def test_long_pieces_and_fallback_rows(setup):
    # >64-byte pieces flag their rows; 17..64-byte pieces take the long path
    _compare(setup, ["x" * 700, "ab" + "c" * 500, "0" * 997, "word" * 12 + " " + "z" * 40,
                     "a\n b", "today\n \n", "🌍🌍🌍 emoji soup 🚀"])


# cap -> (documents, the header's count over that cap: 0 n_pieces, 1 n_miss,
# 2 n_long, 3 n_tokens; None: the non-ASCII cap, every count within its cap)
CAP_CASES = {
    "pieces": (["1a" * 1400], 0),
    "misses": ([" !q" * 700], 1),
    "longs": ([(" " + "a" * 24) * 120], 2),
    "tokens": ([(" " + "a" * 17) * 55], 3),
    "non_ascii": ([CJK * 6], None),
}


@pytest.mark.parametrize("cap", list(CAP_CASES))
def test_header_overflow_each_cap(setup_wide, cap):
    """The header written by the assembly (counts, overflow rule n_pieces >
    p_cap, n_miss > m_cap, n_long > l_cap, n_tokens > t_cap, the scan's
    non-ASCII flag) equals the JAX program's on a chunk over each cap."""
    from tiktoken_tpu_torch.ops.pipeline3 import chunk_caps

    docs, field = CAP_CASES[cap]
    heads = _compare(setup_wide, docs, want_overflow=True, geometry=(K_WIDE, C_WIDE))
    caps = chunk_caps(K_WIDE, C_WIDE)
    limits = np.asarray([caps["p_cap"], caps["m_cap"], caps["l_cap"], caps["t_cap"]])
    over = [h[-5:-1] > limits for h in heads if h[-1]]
    if field is None:
        assert any(not o.any() for o in over), "no chunk over the non-ASCII cap alone"
    else:
        assert any(o[field] for o in over), f"no chunk over the {cap} cap"


def test_long_gather_is_extract_slots_at_row_length(setup):
    """v3's long pieces are gathered by the plain extract_slots with K = KL
    (their starts index rows of KL columns): equal to JAX's extract_long
    (build_pipeline3_fn's own closure) on every chunk, and every live long
    piece starts below KP and ends within its row, so extract_slots' "zero
    past the row" never cuts one."""
    from tiktoken_tpu.ops import pipeline3 as J3

    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops import pipeline3 as P3

    _, _, tables, S, kw = setup
    fn = J3.build_pipeline3_fn(**kw, worst_case=False)
    extract_long = dict(zip(fn.__code__.co_freevars,
                            (c.cell_contents for c in fn.__closure__)))["extract_long"]
    KP, KL = P3.row_geometry(K)
    texts = [(" " + "b" * 63) * 30, "word" * 12 + " " + "z" * 40, (" " + "a" * 24) * 40,
             make_mixed_corpus(1500, seed=4) + (" " + "q" * 20) * 9]
    pc = P3.pack_corpus3([t.encode() for t in texts], K)
    seen = crossing = 0
    for lo in range(0, len(pc.row_off), C - 1):
        inputs, _ = P3.chunk_inputs3(pc, lo, C - 1, C, S)
        calls = []

        def record(name):
            def call(*a, **k):
                out = getattr(kernels.PLAIN_OPS, name)(*a, **k)
                calls.append((name, a, out))
                return out
            return call

        ops = type("Ops", (), {n: staticmethod(record(n)) for n in vars(kernels.PLAIN_OPS)})
        P3.run_chunk(tables, *[torch.from_numpy(x) for x in inputs], K=K, ops=ops)
        (rows, starts, lens, width), got = [(a, out) for n, a, out in calls
                                            if n == "extract_slots"][0]
        assert width == KL
        want = np.asarray(extract_long(jnp.asarray(rows.numpy()), jnp.asarray(starts.numpy()),
                                       jnp.asarray(lens.numpy())))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"chunk {lo}")
        live = lens.numpy() > 0
        col = starts.numpy()[live] % KL
        assert (col < KP).all() and (col + lens.numpy()[live] <= KL).all()
        seen += int(live.sum())
        crossing += int((col + lens.numpy()[live] > K).sum())
    assert seen > 50 and crossing > 0
