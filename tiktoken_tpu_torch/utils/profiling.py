"""Observability: device traces and engine counters.

Wrap a region in :func:`device_trace` to write a ``torch.profiler`` trace
of it (Chrome trace format, for Perfetto or ``chrome://tracing``);
:func:`engine_report` gives the counters and table sizes of every engine
one ``Encoding`` has built; :class:`Throughput` meters bytes per second
on the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the enclosed region with ``torch.profiler``: host activity, and
    the GPU's kernels and copies when CUDA is available. Writes one Chrome
    trace, ``log_dir/trace_<pid>_<ns>.json``, when the region ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Throughput:
    """A wall-clock byte-rate meter for encode loops."""

    def __init__(self) -> None:
        self.bytes = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_bytes: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.bytes += n_bytes

    @property
    def mb_per_s(self) -> float:
        return self.bytes / self.seconds / 1e6 if self.seconds else 0.0


def engine_report(encoding) -> dict:
    """The state of an ``Encoding``'s engines: the native host core's
    (``"active"``, ``"not built yet"``, or ``"unavailable"`` where none can
    be had and the host runs the Python encoder), and for each device engine built
    so far, by device, its ``stats`` and table sizes."""
    report: dict = {
        "name": encoding.name,
        "host_native": ("active" if encoding._core_bpe._native else
                        "not built yet" if encoding._core_bpe._native is None else "unavailable"),
        "engines": {},
    }
    for dev, eng in encoding._engines.items():
        t = eng.tables
        report["engines"][str(dev)] = {
            "stats": dict(eng.stats),
            "tables": {
                "dfa_states": t.scan.consts.shape[0],
                "dfa_classes": t.scan.n_classes,
                "pair_buckets": t.pair_buckets.shape[0],
                "pair_entries": eng.vocab_report["pair_entries"],
                "vocab_buckets": t.vocab_buckets.shape[0],
                "long_vocab_buckets": t.long_buckets.shape[0],
            },
        }
    return report
