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


@pytest.fixture(scope="module")
def setup():
    from tiktoken_tpu.ops import pipeline3 as J3
    from tiktoken_tpu.ops.charclass import prepare_device_tables

    from tiktoken_tpu_torch.convert import tables_from_numpy

    eng = make_encoding("o200k", 800).device_engine
    ct, pt, vt, lvt = eng.char_tables, eng.pair_table, eng.vocab_table, eng.long_vocab_table
    KP, KL = J3.row_geometry(K)
    S = -(-(C * KP + KL + 8) // 128) * 128
    fns = {
        wc: jax.jit(J3.build_pipeline3_fn(
            K=K, C=C, flat_size=S, char_tables=ct, pair_seed=pt.seed,
            pair_buckets=pt.n_buckets, vocab_seed=vt.seed, vocab_buckets=vt.n_buckets,
            long_seed=lvt.seed, long_buckets=lvt.n_buckets, pack24=False, worst_case=wc))
        for wc in (False, True)
    }
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
    return fns, targs, tables_from_numpy(arrays, meta, device="cpu"), S


def _compare(setup, texts, want_overflow=None):
    from tiktoken_tpu.ops import pipeline3 as J3

    from tiktoken_tpu_torch.ops import pipeline3 as P3

    fns, targs, tables, S = setup
    docs = [t.encode() for t in texts]
    pc, pcp = J3.pack_corpus3(docs, K), P3.pack_corpus3(docs, K)
    for f in ("flat", "row_off", "n_payload", "n_total", "is_doc_end", "prev_same_doc",
              "doc_index"):
        np.testing.assert_array_equal(getattr(pcp, f), getattr(pc, f), err_msg=f)
    overflows = []
    for wc in (False, True):
        for lo in range(0, len(pc.row_off), C - 1):
            inputs, _ = J3.chunk_inputs3(pc, lo, C - 1, C, S)
            inputs_p, _ = P3.chunk_inputs3(pcp, lo, C - 1, C, S)
            for a, b in zip(inputs, inputs_p):
                np.testing.assert_array_equal(a, b)
            jt, jh = (np.asarray(x) for x in fns[wc](*targs, *inputs))
            tt, th = P3.run_chunk(tables, *[torch.from_numpy(x) for x in inputs_p], K=K,
                                  worst_case=wc)
            th, tt = th.numpy(), tt.numpy().view(np.uint32)
            assert th.shape == (2 * C + 5,)
            np.testing.assert_array_equal(th, jh, err_msg=f"header wc={wc} lo={lo}")
            nt = int(jh[-2])
            np.testing.assert_array_equal(tt[:nt], jt[:nt], err_msg=f"tokens wc={wc} lo={lo}")
            if wc:
                assert not th[-1], "the worst-case variant cannot overflow"
            else:
                overflows.append(bool(th[-1]))
    if want_overflow is not None:
        assert any(overflows) == want_overflow


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
