"""A corpus document's UTF-8 bytes, as every route of the port takes them.

A ``str`` may hold a lone surrogate (a code point in U+D800-U+DFFF that is
not half of a pair), which has no UTF-8 form. The reference library
encodes such text as if each lone surrogate were U+FFFD, and so does every
route of this package, through ``utf8_bytes``. This module imports nothing,
so that the encoding, the engine, the native core and the stream encoder
all take it.
"""

from __future__ import annotations


def fix_surrogates(text: str) -> str:
    """Lone surrogates become U+FFFD, as in the reference; a surrogate pair
    becomes the character it encodes."""
    return text.encode("utf-16", "surrogatepass").decode("utf-16", "replace")


def utf8_bytes(doc) -> bytes:
    """A document's UTF-8 bytes: a ``str`` encoded (valid text by the plain
    encode, text with lone surrogates after ``fix_surrogates``), bytes as
    they are (bytes that are not UTF-8 included)."""
    if not isinstance(doc, str):
        return bytes(doc)
    try:
        return doc.encode("utf-8")
    except UnicodeEncodeError:
        return fix_surrogates(doc).encode("utf-8")
