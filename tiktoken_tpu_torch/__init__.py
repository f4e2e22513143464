"""tiktoken-tpu on PyTorch and CUDA: the corpus encoder on an NVIDIA GPU.

A port of the JAX package ``tiktoken_tpu`` (which stays the reference),
with the reference library's public API: ``Encoding``, ``get_encoding``
and ``list_encoding_names`` over the plugins of the
``tiktoken_tpu_torch_ext`` namespace package, ``encoding_for_model`` and
``encoding_name_for_model``.
``Encoding.encode_corpus`` runs the v3 (or v2) chunk program through
hand-written CUDA kernels for Hopper (``tiktoken_tpu_torch/csrc``;
``device="cpu"`` runs their plain PyTorch versions instead), the native
host core (``tiktoken_tpu_torch/native``, C++), or both from one queue
(``strategy=``). Both compiled parts come prebuilt in a wheel or are built
at first use (``_build``); with no core and no compiler, the host calls
run the pure-Python encoder.
``tiktoken_tpu_torch.parallel`` spreads the encoder over several devices
and carries the pair-count training step; ``tiktoken_tpu_torch.train`` is
the host trainer. Compiled DFAs are cached on disk
(``ops/artifacts.py``). This package imports nothing of the JAX package.
"""

from tiktoken_tpu_torch.core import Encoding as Encoding
from tiktoken_tpu_torch.load import load_tiktoken_bpe as load_tiktoken_bpe
from tiktoken_tpu_torch.model import (
    encoding_for_model as encoding_for_model,
    encoding_name_for_model as encoding_name_for_model,
)
from tiktoken_tpu_torch.patterns import cl100k_pat_str as cl100k_pat_str
from tiktoken_tpu_torch.patterns import o200k_pat_str as o200k_pat_str
from tiktoken_tpu_torch.patterns import r50k_pat_str as r50k_pat_str
from tiktoken_tpu_torch.registry import (
    get_encoding as get_encoding,
    list_encoding_names as list_encoding_names,
)

__version__ = "0.3.0"
