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


def _jax_b16(jt, KL: int, K: int):
    """The JAX B16 (classes + scan, jitted on XLA:CPU) at one geometry:
    (rows, pays, tots) -> (classes_ext, mask, bad, na_overflow)."""
    from tiktoken_tpu.ops.charclass import make_byte_classes_fn, prepare_device_tables
    from tiktoken_tpu.ops.sweep_scan import make_char_scan_fn

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

    return run


@pytest.fixture(scope="module", params=PAT_NAMES)
def jax_scan(request):
    """The JAX B16 at the test geometry, and the tables."""
    jt, pt, st = _tables(request.param)
    return _jax_b16(jt, KL, K), pt, st


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


def _step_bound():
    """scripts/scan_step_bound.py, the exact most steps of a walk."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "scan_step_bound.py"
    spec = importlib.util.spec_from_file_location("scan_step_bound", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _uncapped_steps(st, rows, pays, tots):
    """The plain walk's steps over rows [B, L], the step cap out of reach."""
    from tiktoken_tpu_torch.ops.sweep_scan import row_classes, walk_steps

    L = rows.shape[1]
    t = torch.from_numpy(tots)
    cls, _ = row_classes(st, torch.from_numpy(rows), t, 2)  # no non-ASCII cap
    cls = torch.cat([cls, torch.full((len(rows), 3 * L), st.eof_class, dtype=cls.dtype)], 1)
    return walk_steps(st, cls, torch.from_numpy(pays), t).numpy()


def test_walk_step_bound_is_exact(jax_scan):
    """The dynamic program of scripts/scan_step_bound.py gives the most steps
    a walk can take over a row of n bytes; the row it builds takes exactly
    that many in the port's walk. r50k never reaches the step cap 3 * (n + 2);
    cl100k and o200k pass it from 27 bytes (newlines, tabs and 4-byte digits)."""
    _run, pt, st = jax_scan
    sb = _step_bound().StepBound(pt, KL)
    n = np.arange(KL + 1)
    for m in (40, KL):
        row, steps = sb.row(m)
        assert len(row) == m and steps <= sb.most[m]
        grid = np.zeros((1, KL), np.uint8)
        grid[0, :m] = np.frombuffer(row, np.uint8)
        tot = np.asarray([m], np.int32)
        assert _uncapped_steps(st, grid, tot, tot)[0] == steps, m
    if sb.most[KL] <= 3 * KL:  # r50k
        assert (sb.most[1:] <= 3 * n[1:]).all()
    else:
        assert np.nonzero(sb.most > 3 * (n + 2))[0][0] == 27


# Rows of the v2 geometry (K = 256, KL = 272), within its non-ASCII cap of 34
# char ends, whose walks under cl100k and o200k need 1, 2 and 3 steps more
# than the cap 3 * (KL + 2) = 822: a newline, two tabs and a digit, repeated
# (x a 4-byte digit, a and d 2- and 3-byte ones). The first two fill a row
# with a payload of K. STEP_CAP_DOC's lines are rows as pack_documents cuts
# them (a newline then a letter is a safe split), each needing 825 steps:
# bad in JAX on the CPU too, finished by its 24-step bodies on the TPU.
_DIGITS = {"x": "\U0001d7ce", "0": "0", "a": "\u0663", "d": "\u0967"}


def _units(digits: str) -> str:
    return "".join("\n\t\t" + _DIGITS[c] for c in digits)


WINDOW_ROWS = (_units("x0xxxxx00xxxx0000xxxxxx0xxxx0xxxxxxxxx0xx0x0"),
               _units("x0xxx0xxxxxx0xxxxx0dxxx0xx0ax0xxxxd0xxxa0x0d") + "\n")
STEP_CAP_DOC = ("A" + _units("x00xxx0xxx00dxx0" + "x" * 23) + "\n") * 3


@pytest.mark.parametrize("name", PAT_NAMES)
def test_rows_just_past_the_step_cap(name):
    """The port and the numpy spec stop a walk after 3 * (KL + 2) steps and
    call the row bad; the JAX kernel checks its cap between unrolled bodies
    of 4 steps on the CPU, so at KL = 272 it walks 824 steps and finishes a
    row that needs 823 or 824. On such rows the port equals the spec, and
    JAX differs by design with the mask of the uncapped walk; past both caps
    all three call the row bad; under r50k, which never reaches the cap, all
    three agree. The documents' ids: test_torch_pipeline2.py."""
    from tiktoken_tpu_torch.ops.sweep_scan import char_scan_numpy, char_scan_rows

    K2, KL2 = 256, 272
    jt, pt, st = _tables(name)
    cap, jax_cap = 3 * (KL2 + 2), -(-3 * (KL2 + 2) // 4) * 4
    data = [r.encode() for r in WINDOW_ROWS] + [STEP_CAP_DOC.encode()[:KL2]]
    rows = np.zeros((len(data), KL2), np.uint8)
    for i, d in enumerate(data):
        rows[i, : len(d)] = np.frombuffer(d, np.uint8)
    tots = np.asarray([len(d) for d in data], np.int32)
    pays = np.full(len(data), K2, np.int32)
    steps = _uncapped_steps(st, rows, pays, tots)
    assert tots.tolist() == [KL2] * 3 and steps.tolist() == (
        [607, 605, 610] if name == "r50k" else [cap + 1, cap + 2, cap + 3])
    cls_ext, jm, jb, jover = _jax_b16(jt, KL2, K2)(rows, pays, tots)
    m, b, over = char_scan_rows(st, *(torch.from_numpy(x) for x in (rows, pays, tots)),
                                K=K2, na_frac=8)
    assert not jover and not bool(over)
    wide = np.concatenate([cls_ext, np.full((len(data), 3 * KL2), pt.eof_class, cls_ext.dtype)],
                          axis=1)
    for i in range(len(data)):
        wm, wb = char_scan_numpy(pt, cls_ext[i], K2, KL2, K2)
        np.testing.assert_array_equal(m[i].numpy(), wm)
        assert bool(b[i]) == wb == (steps[i] > cap), i
        if cap < steps[i] <= jax_cap:
            assert not jb[i]
            np.testing.assert_array_equal(jm[i], char_scan_numpy(pt, wide[i], K2, KL2, K2)[0])
        else:  # a row past both caps is bad in both, its mask cut where each stopped
            assert jb[i] == wb, i
            if not wb:
                np.testing.assert_array_equal(jm[i], wm)


def test_char_scan_wrapper_rejects_non_cuda_devices():
    from tiktoken_tpu_torch.ops import kernels

    _jt, _pt, st = _tables("o200k")
    m = torch.empty((4, KL), dtype=torch.uint8, device="meta")
    z = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.char_scan(st, m, z, z, K=K, na_frac=8)
