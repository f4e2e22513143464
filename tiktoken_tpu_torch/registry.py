"""The encoding registry and its plugin discovery.

The reference registry's behaviour (reference: tiktoken/registry.py): a
thread-safe cache of one ``Encoding`` object per name, built at the first
``get_encoding``; plugins are the modules of the ``tiktoken_tpu_torch_ext``
namespace package, each with an ``ENCODING_CONSTRUCTORS`` dict; a plugin
without one, or a name two plugins define, raises ``ValueError``; a failed
discovery leaves the registry empty, so that a later call tries again.
"""

from __future__ import annotations

import functools
import importlib
import pkgutil
import threading
from typing import Any, Callable

import tiktoken_tpu_torch_ext

from tiktoken_tpu_torch.core import Encoding

_lock = threading.RLock()

# one Encoding per name; Encoding.__getstate__ pickles these by name
ENCODINGS: dict[str, Encoding] = {}

_constructors: dict[str, Callable[[], dict[str, Any]]] | None = None


@functools.lru_cache
def _available_plugin_modules() -> tuple[str, ...]:
    # a namespace package: any directory on sys.path may add a module to it
    prefix = tiktoken_tpu_torch_ext.__name__ + "."
    return tuple(info.name
                 for info in pkgutil.iter_modules(tiktoken_tpu_torch_ext.__path__, prefix))


def _discover_constructors() -> dict[str, Callable[[], dict[str, Any]]]:
    found: dict[str, Callable[[], dict[str, Any]]] = {}
    for mod_name in _available_plugin_modules():
        mod = importlib.import_module(mod_name)
        try:
            constructors = mod.ENCODING_CONSTRUCTORS
        except AttributeError as e:
            raise ValueError(
                f"tiktoken_tpu_torch plugin {mod_name} does not define ENCODING_CONSTRUCTORS"
            ) from e
        for enc_name, constructor in constructors.items():
            if enc_name in found:
                raise ValueError(
                    f"Duplicate encoding name {enc_name} in tiktoken_tpu_torch plugin {mod_name}"
                )
            found[enc_name] = constructor
    return found


def _get_constructors() -> dict[str, Callable[[], dict[str, Any]]]:
    # the caller holds _lock; a discovery that raises leaves _constructors
    # None, so the next call discovers again
    global _constructors
    if _constructors is None:
        _constructors = _discover_constructors()
    return _constructors


def get_encoding(encoding_name: str) -> Encoding:
    """The ``Encoding`` registered as ``encoding_name``, built at the first
    call and the same object at every later one."""
    if not isinstance(encoding_name, str):
        raise ValueError(
            f"Expected a string in get_encoding, got {type(encoding_name)}: {encoding_name!r}"
        )

    enc = ENCODINGS.get(encoding_name)
    if enc is not None:
        return enc

    with _lock:
        enc = ENCODINGS.get(encoding_name)
        if enc is not None:
            return enc

        constructors = _get_constructors()
        if encoding_name not in constructors:
            raise ValueError(
                f"Unknown encoding {encoding_name}.\n"
                f"Plugins found: {_available_plugin_modules()}"
            )

        enc = Encoding(**constructors[encoding_name]())
        ENCODINGS[encoding_name] = enc
        return enc


def list_encoding_names() -> list[str]:
    """The names of every registered encoding."""
    with _lock:
        return list(_get_constructors())
