"""Model name -> encoding name.

The reference's rule (reference: tiktoken/model.py:88-118): an exact model
name wins; else the first prefix in ``MODEL_PREFIX_TO_ENCODING``'s order
that the name starts with; else ``KeyError``.
"""

from __future__ import annotations

from tiktoken_tpu_torch.core import Encoding
from tiktoken_tpu_torch.registry import get_encoding

# exact model names, by encoding (reference: tiktoken/model.py:29-85)
_MODELS_BY_ENCODING: dict[str, tuple[str, ...]] = {
    "o200k_base": (
        "o1", "o3", "o4-mini",          # reasoning
        "gpt-5", "gpt-4.1", "gpt-4o",   # chat
    ),
    "cl100k_base": (
        "gpt-4", "gpt-3.5-turbo", "gpt-3.5", "gpt-35-turbo",
        "davinci-002", "babbage-002",
        "text-embedding-ada-002", "text-embedding-3-small", "text-embedding-3-large",
    ),
    "p50k_base": (
        # deprecated text and code models
        "text-davinci-003", "text-davinci-002",
        "code-davinci-002", "code-davinci-001",
        "code-cushman-002", "code-cushman-001",
        "davinci-codex", "cushman-codex",
    ),
    "p50k_edit": (
        "text-davinci-edit-001", "code-davinci-edit-001",
    ),
    "r50k_base": (
        "text-davinci-001", "text-curie-001", "text-babbage-001", "text-ada-001",
        "davinci", "curie", "babbage", "ada",
        "text-similarity-davinci-001", "text-similarity-curie-001",
        "text-similarity-babbage-001", "text-similarity-ada-001",
        "text-search-davinci-doc-001", "text-search-curie-doc-001",
        "text-search-babbage-doc-001", "text-search-ada-doc-001",
        "code-search-babbage-code-001", "code-search-ada-code-001",
    ),
    "gpt2": ("gpt2", "gpt-2"),
}

# versioned-name prefixes in the order they are tried (reference:
# tiktoken/model.py:7-27): "gpt-4o-" must come before "gpt-4-"
_PREFIX_RULES: tuple[tuple[str, str], ...] = (
    ("o1-", "o200k_base"),
    ("o3-", "o200k_base"),
    ("o4-mini-", "o200k_base"),
    ("gpt-5-", "o200k_base"),
    ("gpt-4.5-", "o200k_base"),
    ("gpt-4.1-", "o200k_base"),
    ("chatgpt-4o-", "o200k_base"),
    ("gpt-4o-", "o200k_base"),
    ("gpt-4-", "cl100k_base"),
    ("gpt-3.5-turbo-", "cl100k_base"),
    ("gpt-35-turbo-", "cl100k_base"),  # Azure deployment name
    ("gpt-oss-", "o200k_harmony"),
    ("ft:gpt-4o", "o200k_base"),
    ("ft:gpt-4", "cl100k_base"),
    ("ft:gpt-3.5-turbo", "cl100k_base"),
    ("ft:davinci-002", "cl100k_base"),
    ("ft:babbage-002", "cl100k_base"),
)

MODEL_TO_ENCODING: dict[str, str] = {
    model: encoding for encoding, models in _MODELS_BY_ENCODING.items() for model in models
}

MODEL_PREFIX_TO_ENCODING: dict[str, str] = dict(_PREFIX_RULES)


def encoding_name_for_model(model_name: str) -> str:
    """The name of the encoding a model uses; ``KeyError`` for a model name
    that neither matches nor starts with a known prefix."""
    encoding_name = MODEL_TO_ENCODING.get(model_name)
    if encoding_name is not None:
        return encoding_name

    # a prefix also matches model names that do not exist
    # (e.g. gpt-3.5-turbo-FAKE), so new versions need no update here
    for prefix, prefixed_encoding_name in MODEL_PREFIX_TO_ENCODING.items():
        if model_name.startswith(prefix):
            return prefixed_encoding_name

    raise KeyError(
        f"Could not automatically map {model_name} to a tokeniser. "
        "Please use `tiktoken_tpu_torch.get_encoding` to explicitly get the tokeniser you expect."
    ) from None


def encoding_for_model(model_name: str) -> Encoding:
    """The encoding a model uses; ``KeyError`` as in
    ``encoding_name_for_model``."""
    return get_encoding(encoding_name_for_model(model_name))
