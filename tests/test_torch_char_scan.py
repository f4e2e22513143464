"""PyTorch port: the v2 char-level scan (B16, the ``char_scan`` entry of
the ``scan_rows`` kernel) on the CPU against the JAX
``make_byte_classes_fn`` + ``make_char_scan_fn(handshake=False)`` on
XLA:CPU and against the numpy spec ``char_scan_numpy``, for the three
device patterns. The char tables are carried across from the JAX
compiler. All outputs are integers: exact equality."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import PAT_NAMES, make_mixed_corpus, pat_str

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。春はあけぼの、やうやう白くなりゆく山際。"
CYR = "Широкая электрификация южных губерний даст мощный толчок подъёму сельского хозяйства. "
K, KL = 64, 80  # v2 geometry: KL = K + 16; na cap max(8, 80 / 8) = 10 char ends


def _tables(name: str):
    """(JAX CharClassTables, the port's CharClassTables over the same
    arrays, the port's ScanTables on the CPU)."""
    from tiktoken_tpu.ops.charclass import build_char_class_tables
    from tiktoken_tpu.ops.regex_compiler import compile_pattern_chars

    from tiktoken_tpu_torch.ops import charclass, sweep_scan

    jt = build_char_class_tables(compile_pattern_chars(pat_str(name)))
    pt = charclass.CharClassTables(
        page_entry=np.asarray(jt.page_entry, np.int32),
        mixed_rows=np.asarray(jt.mixed_rows, np.uint8), n_classes=int(jt.n_classes),
        eof_class=int(jt.eof_class), n_states=int(jt.n_states),
        trans=np.asarray(jt.trans, np.int32), accept=np.asarray(jt.accept, np.int8))
    return jt, pt, sweep_scan.scan_tables(pt, sweep_scan.build_scan_consts(pt),
                                          torch.device("cpu"))


def _row(data: bytes, n_payload: int, n_total: int):
    row = np.zeros(KL, np.uint8)
    row[: min(len(data), KL)] = np.frombuffer(data[:KL], np.uint8)
    return row, n_payload, n_total


def _rows(seed: int):
    """Random rows of a mixed corpus, then the edge rows; (rows [B, KL] u8,
    n_payload, n_total [B] i32, index of the first edge row)."""
    rng = np.random.default_rng(seed)
    corpus = (make_mixed_corpus(6000, seed=seed) + CYR + "1" * 200).encode()
    out = []
    for _ in range(40):
        off = int(rng.integers(0, len(corpus) - KL))
        t = int(rng.integers(0, KL + 1))
        out.append(_row(corpus[off : off + KL], int(rng.integers(0, min(t, K) + 1)), t))
    n_random = len(out)
    cjk = (CJK * 4).encode()
    out += [
        _row(corpus[:KL], 0, KL),  # n_payload 0
        _row(corpus[100 : 100 + KL], K, 37),  # n_total < KL (and < n_payload)
        _row(b"words and more words" * 4, 50, 60),  # n_total < KL
        _row(cjk[1:], K, KL),  # starts inside a multi-byte character
        _row(cjk, K, KL),  # CJK: over the non-ASCII cap
        _row(cjk[:30] + b" tail of ascii words", 49, 49),
        _row(b"a\n b", 4, 4),  # whitespace runs
        _row(b"today\n \n", 8, 8),
        _row(b"", 0, 0),  # a zero-padded row, as upload_rows pads a chunk
        _row(b"", 0, 0),
    ]
    rows, pays, tots = zip(*out)
    return (np.stack(rows), np.asarray(pays, np.int32), np.asarray(tots, np.int32), n_random)


@pytest.fixture(scope="module", params=PAT_NAMES)
def jax_scan(request):
    """The JAX B16 (classes + scan, jitted on XLA:CPU) and the tables."""
    from tiktoken_tpu.ops.charclass import make_byte_classes_fn, prepare_device_tables
    from tiktoken_tpu.ops.sweep_scan import make_char_scan_fn

    jt, pt, st = _tables(request.param)
    prep = prepare_device_tables(jt)
    classes = jax.jit(make_byte_classes_fn(jt))
    scan = jax.jit(make_char_scan_fn(jt, KL, K))

    def run(rows, pays, tots):
        cls, over = classes(jnp.asarray(prep["page_planes"]), jnp.asarray(prep["mixed_t"]),
                            jnp.asarray(rows), jnp.asarray(tots))
        cls_ext = jnp.concatenate(
            [cls, jnp.full((rows.shape[0], 1), jt.eof_class, cls.dtype)], axis=1)
        mask, bad = scan(cls_ext, jnp.asarray(pays), jnp.asarray(tots))
        return np.array(cls_ext), np.asarray(mask), np.asarray(bad), bool(over)

    return run, pt, st


def test_char_scan_rows_matches_jax_and_numpy(jax_scan):
    from tiktoken_tpu_torch.ops import kernels
    from tiktoken_tpu_torch.ops.sweep_scan import char_scan, char_scan_numpy, char_scan_rows

    run, pt, st = jax_scan
    rows, pays, tots, n_random = _rows(5)
    cls_ext, jm, jb, jover = run(rows, pays, tots)
    t_rows, t_pays, t_tots = (torch.from_numpy(x) for x in (rows, pays, tots))
    m, b, over = char_scan_rows(st, t_rows, t_pays, t_tots, K=K, na_frac=8)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(b.numpy(), jb)
    assert bool(over) and jover  # the CJK row
    # the scan alone, on the JAX classes
    m2, b2 = char_scan(st.consts, torch.from_numpy(cls_ext), t_pays, t_tots, K=K,
                       cont_class=st.cont_class, eof_class=st.eof_class)
    np.testing.assert_array_equal(m2.numpy(), jm)
    np.testing.assert_array_equal(b2.numpy(), jb)
    for i in range(len(pays)):
        wm, wb = char_scan_numpy(pt, cls_ext[i], int(pays[i]), int(tots[i]), K)
        np.testing.assert_array_equal(m[i].numpy(), wm, err_msg=str(i))
        assert bool(b[i]) == wb, i
    # the wrapper takes the plain version on CPU tensors
    km, kb, kover = kernels.char_scan(st, t_rows, t_pays, t_tots, K=K, na_frac=8)
    assert torch.equal(km, m) and torch.equal(kb, b) and bool(kover) == bool(over)
    # no payload or a zero-padded row: nothing, and not bad; a piece that
    # starts on a continuation byte dies without progress: bad
    assert not m[pays == 0].any() and not b[pays == 0].any()
    assert b[n_random + 3] and not b[n_random + 6 : n_random + 8].any()
    assert (~b[:n_random]).sum() > n_random // 2 and m[:n_random].any()


def test_na_overflow_only_past_the_cap(jax_scan):
    from tiktoken_tpu_torch.ops.sweep_scan import char_scan_rows

    run, _pt, st = jax_scan
    cjk = (CJK * 4).encode()
    for data, over in ((cjk[:30], False), (cjk[:33], True)):  # 10 and 11 non-ASCII char ends
        rows = np.stack([_row(data, 0, 0)[0], _row(b"x y", 0, 0)[0]])
        pays = tots = np.asarray([len(data), 3], np.int32)
        _cls, jm, jb, jover = run(rows, pays, tots)
        m, b, got = char_scan_rows(st, *(torch.from_numpy(x) for x in (rows, pays, tots)),
                                   K=K, na_frac=8)
        assert bool(got) == jover == over, len(data)
        np.testing.assert_array_equal(m.numpy(), jm)
        np.testing.assert_array_equal(b.numpy(), jb)


def test_char_scan_wrapper_rejects_non_cuda_devices():
    from tiktoken_tpu_torch.ops import kernels

    _jt, _pt, st = _tables("o200k")
    m = torch.empty((4, KL), dtype=torch.uint8, device="meta")
    z = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.char_scan(st, m, z, z, K=K, na_frac=8)
