"""PyTorch port: the chunk programs run the package's kernel entries and
nothing else on the device.

``run_chunk`` (v3), ``run_chunk2`` (v2, both scanners) and ``run_rows1``
(v1) run on CPU tensors with an ``ops`` namespace that wraps the package's
entries (``kernels.KERNEL_OPS``, which take the plain versions on the
CPU); a ``TorchDispatchMode`` records every aten operation dispatched
outside those entries. Only views may appear there: they launch nothing on
a device. And the assembly reads nothing of the catalog past ``n_pieces``:
entries past it may hold anything."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.helpers import make_encoding, make_mixed_corpus, pat_str

CJK = "東京タワーは高い。パリは花の都、そして京都は古都です。"


@pytest.fixture(scope="module")
def engine():
    import tiktoken_tpu_torch

    ranks = dict(make_encoding("o200k", 800)._mergeable_ranks)
    enc = tiktoken_tpu_torch.Encoding("glue", pat_str=pat_str("o200k"), mergeable_ranks=ranks,
                                      special_tokens={})
    return enc.engine("cpu")


class _Outside(TorchDispatchMode):
    """Records the aten operations dispatched while no entry runs."""

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0 and not func.is_view:
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _run(program):
    """program(ops) under the dispatch mode -> (its output, the entries it
    called, the operations dispatched outside them)."""
    from tiktoken_tpu_torch.ops import kernels

    mode, calls = _Outside(), []

    def wrap(name):
        fn = getattr(kernels.KERNEL_OPS, name)

        def call(*args, **kwargs):
            mode.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.depth -= 1
                calls.append(name)

        return call

    ops = SimpleNamespace(**{name: wrap(name) for name in vars(kernels.KERNEL_OPS)})
    with mode:
        out = program(ops)
    return out, calls, mode.ops


TEXTS = [make_mixed_corpus(1200, seed=2), "word" * 12 + " " + "z" * 40, (" " + "b" * 40) * 6,
         CJK * 4, "x" * 300]


@pytest.mark.parametrize("worst_case", [False, True])
def test_v3_chunk_program_runs_only_entries(engine, worst_case):
    from tiktoken_tpu_torch.ops import pipeline3 as P3

    K, C = 96, 8
    KP, KL = P3.row_geometry(K)
    S = -(-(C * KP + KL + 8) // 128) * 128
    pc = P3.pack_corpus3([t.encode() for t in TEXTS], K)
    inputs = [torch.from_numpy(x) for x in P3.chunk_inputs3(pc, 0, C - 1, C, S)[0]]
    (tok, header), calls, outside = _run(
        lambda ops: P3.run_chunk(engine.tables, *inputs, K=K, worst_case=worst_case, ops=ops))
    assert outside == []
    assert calls[-1] == "assemble" and "extract_slots" in calls
    assert header.shape == (2 * C + 5,) and tok.dtype == torch.int32


@pytest.mark.parametrize("scanner", ["char", "byte"])
def test_v2_and_v1_programs_run_only_entries(engine, scanner):
    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_chunk2, run_rows1

    C, K = 8, 256
    b = pack_documents([t.encode() for t in TEXTS], K)
    rows, pay, tot = (torch.from_numpy(np.ascontiguousarray(a[:C]))
                      for a in (b.rows, b.n_payload, b.n_total))
    tables = engine.byte_tables() if scanner == "byte" else engine.tables
    (_, header), calls, outside = _run(
        lambda ops: run_chunk2(tables, rows, pay, tot, scanner=scanner, ops=ops))
    assert outside == []
    assert calls[-1] == "assemble" and header.shape == (2 * C + 2,)
    if scanner == "byte":
        _, calls1, outside1 = _run(lambda ops: run_rows1(tables, rows, pay, tot, ops=ops))
        assert outside1 == [] and calls1 == ["window_orbit", "grid_merge"]


def test_assemble_reads_nothing_past_n_pieces(engine):
    """The assembly of a real v2 chunk is the same whatever the catalog
    holds past n_pieces (lengths, hits, slots, words and starts)."""
    from tiktoken_tpu_torch.ops import compaction, kernels
    from tiktoken_tpu_torch.ops.engine import pack_documents
    from tiktoken_tpu_torch.ops.pipeline2 import run_chunk2

    C, K = 8, 256
    b = pack_documents([t.encode() for t in TEXTS], K)
    rows, pay, tot = (torch.from_numpy(np.ascontiguousarray(a[:C]))
                      for a in (b.rows, b.n_payload, b.n_total))
    seen = {}

    def record(name):
        def call(*args, **kwargs):
            seen[name] = (args, kwargs)
            return getattr(kernels.PLAIN_OPS, name)(*args, **kwargs)
        return call

    ops = SimpleNamespace(**{name: record(name) for name in vars(kernels.PLAIN_OPS)})
    tok, header = run_chunk2(engine.tables, rows, pay, tot, ops=ops)
    args, kwargs = seen["assemble"]
    n = int(args[0])
    p = args[1].shape[0]
    assert 0 < n < p
    rng = np.random.default_rng(3)
    garbled = list(args)
    for i in (1, 2, 3, 5, 6, 11):  # lens, hit, words, mslot, lslot, starts
        t = args[i].clone()
        t[n:] = torch.from_numpy(rng.integers(-5, 300, size=t[n:].shape).astype(np.int32))
        garbled[i] = t
    tok2, header2 = compaction.assemble(*garbled, **kwargs)
    nt = int(header[-2])
    assert torch.equal(header2, header) and torch.equal(tok2[:nt], tok[:nt])
