"""The shipped encodings of ``tiktoken_tpu_torch``, as constructors.

The same seven encodings, vocabulary URLs, sha256 pins, special tokens and
split patterns as the reference (reference: tiktoken_ext/openai_public.py),
over the port's loaders and the patterns of ``tiktoken_tpu_torch.patterns``.
``tiktoken_tpu_torch_ext`` is a namespace package (no ``__init__.py``): a
module in it with an ``ENCODING_CONSTRUCTORS`` dict, from any directory on
``sys.path``, adds encodings to ``tiktoken_tpu_torch.get_encoding``.
"""

from __future__ import annotations

from tiktoken_tpu_torch.load import data_gym_to_mergeable_bpe_ranks, load_tiktoken_bpe
from tiktoken_tpu_torch.patterns import cl100k_pat_str, o200k_pat_str, r50k_pat_str

ENDOFTEXT = "<|endoftext|>"
FIM_PREFIX = "<|fim_prefix|>"
FIM_MIDDLE = "<|fim_middle|>"
FIM_SUFFIX = "<|fim_suffix|>"
ENDOFPROMPT = "<|endofprompt|>"

_BLOB = "https://openaipublic.blob.core.windows.net"

# name -> (url, sha256)
_TIKTOKEN_FILES: dict[str, tuple[str, str]] = {
    "r50k_base": (
        f"{_BLOB}/encodings/r50k_base.tiktoken",
        "306cd27f03c1a714eca7108e03d66b7dc042abe8c258b44c199a7ed9838dd930",
    ),
    "p50k_base": (
        f"{_BLOB}/encodings/p50k_base.tiktoken",
        "94b5ca7dff4d00767bc256fdd1b27e5b17361d7b8a5f968547f9f23eb70d2069",
    ),
    "cl100k_base": (
        f"{_BLOB}/encodings/cl100k_base.tiktoken",
        "223921b76ee99bde995b7ff738513eef100fb51d18c93597a113bcffe865b2a7",
    ),
    "o200k_base": (
        f"{_BLOB}/encodings/o200k_base.tiktoken",
        "446a9538cb6c348e3516120d7c08b09f57c36495e2acfffe59a5bf8b0cfb1a2d",
    ),
}


def _ranks(vocab: str) -> dict[bytes, int]:
    url, sha = _TIKTOKEN_FILES[vocab]
    return load_tiktoken_bpe(url, expected_hash=sha)


def gpt2():
    mergeable_ranks = data_gym_to_mergeable_bpe_ranks(
        vocab_bpe_file=f"{_BLOB}/gpt-2/encodings/main/vocab.bpe",
        encoder_json_file=f"{_BLOB}/gpt-2/encodings/main/encoder.json",
        vocab_bpe_hash="1ce1664773c50f3e0cc8842619a93edc4624525b728b188a9e0be33b7726adc5",
        encoder_json_hash="196139668be63f3b5d6574427317ae82f612a97c5d1cdaf36ed2256dbf636783",
    )
    return {
        "name": "gpt2",
        "explicit_n_vocab": 50257,
        "pat_str": r50k_pat_str,
        "mergeable_ranks": mergeable_ranks,
        "special_tokens": {ENDOFTEXT: 50256},
    }


def r50k_base():
    return {
        "name": "r50k_base",
        "explicit_n_vocab": 50257,
        "pat_str": r50k_pat_str,
        "mergeable_ranks": _ranks("r50k_base"),
        "special_tokens": {ENDOFTEXT: 50256},
    }


def p50k_base():
    return {
        "name": "p50k_base",
        "explicit_n_vocab": 50281,
        "pat_str": r50k_pat_str,
        "mergeable_ranks": _ranks("p50k_base"),
        "special_tokens": {ENDOFTEXT: 50256},
    }


def p50k_edit():
    return {
        "name": "p50k_edit",
        "pat_str": r50k_pat_str,
        "mergeable_ranks": _ranks("p50k_base"),
        "special_tokens": {
            ENDOFTEXT: 50256,
            FIM_PREFIX: 50281,
            FIM_MIDDLE: 50282,
            FIM_SUFFIX: 50283,
        },
    }


def cl100k_base():
    return {
        "name": "cl100k_base",
        "pat_str": cl100k_pat_str,
        "mergeable_ranks": _ranks("cl100k_base"),
        "special_tokens": {
            ENDOFTEXT: 100257,
            FIM_PREFIX: 100258,
            FIM_MIDDLE: 100259,
            FIM_SUFFIX: 100260,
            ENDOFPROMPT: 100276,
        },
    }


def o200k_base():
    return {
        "name": "o200k_base",
        "pat_str": o200k_pat_str,
        "mergeable_ranks": _ranks("o200k_base"),
        "special_tokens": {ENDOFTEXT: 199999, ENDOFPROMPT: 200018},
    }


# o200k_harmony's named specials for ids 199998..200012; 200013..201087 are
# all <|reserved_N|>. The reserved fill is unconditional, so id 200018 has
# two keys (<|endofprompt|> from the base encoding and <|reserved_200018|>),
# as in the reference (reference: tiktoken_ext/openai_public.py:128-145).
_HARMONY_NAMED: dict[int, str] = {
    199998: "<|startoftext|>",
    199999: ENDOFTEXT,
    200002: "<|return|>",
    200003: "<|constrain|>",
    200005: "<|channel|>",
    200006: "<|start|>",
    200007: "<|end|>",
    200008: "<|message|>",
    200012: "<|call|>",
}


def o200k_harmony():
    base = o200k_base()
    special_tokens = dict(base["special_tokens"])
    for i in range(199998, 200013):
        special_tokens[_HARMONY_NAMED.get(i, f"<|reserved_{i}|>")] = i
    for i in range(200013, 201088):
        special_tokens[f"<|reserved_{i}|>"] = i
    return {
        "name": "o200k_harmony",
        "pat_str": base["pat_str"],
        "mergeable_ranks": base["mergeable_ranks"],
        "special_tokens": special_tokens,
    }


ENCODING_CONSTRUCTORS = {
    "gpt2": gpt2,
    "r50k_base": r50k_base,
    "p50k_base": p50k_base,
    "p50k_edit": p50k_edit,
    "cl100k_base": cl100k_base,
    "o200k_base": o200k_base,
    "o200k_harmony": o200k_harmony,
}
