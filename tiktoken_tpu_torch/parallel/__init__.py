"""Several devices: the device list, sharded corpus encoding, the
checkpointed stream encoder, and the distributed pair-count training step.

The counterpart of the JAX package's ``tiktoken_tpu.parallel``: a mesh is
a list of ``torch.device`` (``data_mesh``), the tables are replicated per
device, the forward pass is collective-free within a process with counters
summed on the host, and the training step sums its histograms over the
devices. Given a ``torch.distributed`` process group (one process per GPU,
NCCL on the card, gloo on the CPU), ``ShardedEngine`` splits each call
over the processes and gathers once per call, after one ``all_reduce`` of
its failure flags and counters, and the training step all-reduces its
histogram (``parallel/collective.py``).
"""

from tiktoken_tpu_torch.parallel.encode import CorpusStats, ShardedEngine
from tiktoken_tpu_torch.parallel.mesh import data_mesh
from tiktoken_tpu_torch.parallel.stream import StreamEncoder
from tiktoken_tpu_torch.parallel.train import HIST_BITS, corpus_pair_counts, pair_count_step

__all__ = [
    "HIST_BITS",
    "CorpusStats",
    "ShardedEngine",
    "StreamEncoder",
    "corpus_pair_counts",
    "data_mesh",
    "pair_count_step",
]
