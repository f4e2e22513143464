"""Unicode data for the pattern compiler.

The reference's split patterns use Unicode general-category classes
(``\\p{L}``, ``\\p{N}``, ``\\p{Lu}``, ``\\p{M}``...), the White_Space
property (``\\s``), and case-insensitive groups with Unicode case folding
(reference: tiktoken_ext/openai_public.py:12-114; the engine is the Rust
regex crate via fancy_regex). This module derives the needed codepoint
sets from CPython's ``unicodedata`` so the byte-DFA compiler can expand
them into char classes.

All sets are interval lists: sorted, disjoint, inclusive (lo, hi) pairs.

The override deltas (``_unicode_overrides``) are computed against
Unicode 15.0.0; tables built from any other ``unicodedata`` would be
silently wrong, so ``require_unicode_version`` refuses to build them.
"""

from __future__ import annotations

import functools
import sys
import unicodedata

MAX_CP = 0x10FFFF
UNIDATA_VERSION = "15.0.0"  # the version the override deltas were probed for

Interval = tuple[int, int]
IntervalSet = tuple[Interval, ...]

# Unicode White_Space property codepoints (what the reference engine's \s
# matches; deliberately NOT Python's str.isspace set).
WHITE_SPACE_CPS: tuple[int, ...] = (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
    0x2000, 0x2001, 0x2002, 0x2003, 0x2004, 0x2005, 0x2006, 0x2007,
    0x2008, 0x2009, 0x200A, 0x2028, 0x2029, 0x202F, 0x205F, 0x3000,
)


def require_unicode_version() -> None:
    """Raise unless CPython's unicodedata is the version the overrides
    were generated against."""
    if unicodedata.unidata_version != UNIDATA_VERSION:
        raise RuntimeError(
            f"unicodedata is Unicode {unicodedata.unidata_version}, but the "
            f"category overrides are deltas against {UNIDATA_VERSION}; "
            "char-class tables built here would be wrong"
        )


def cps_to_intervals(cps) -> IntervalSet:
    """Pack an iterable of codepoints into sorted inclusive intervals."""
    out: list[Interval] = []
    for cp in sorted(set(cps)):
        if out and cp == out[-1][1] + 1:
            out[-1] = (out[-1][0], cp)
        else:
            out.append((cp, cp))
    return tuple(out)


def union(*sets: IntervalSet) -> IntervalSet:
    merged = sorted(iv for s in sets for iv in s)
    out: list[Interval] = []
    for lo, hi in merged:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def negate(s: IntervalSet, max_cp: int = MAX_CP) -> IntervalSet:
    """Complement within [0, max_cp], excluding surrogates (which cannot
    appear in well-formed UTF-8 and must never be matched)."""
    out: list[Interval] = []
    prev = -1
    for lo, hi in s:
        if lo > prev + 1:
            out.append((prev + 1, lo - 1))
        prev = max(prev, hi)
    if prev < max_cp:
        out.append((prev + 1, max_cp))
    # Remove the surrogate range D800-DFFF.
    cleaned: list[Interval] = []
    for lo, hi in out:
        if hi < 0xD800 or lo > 0xDFFF:
            cleaned.append((lo, hi))
            continue
        if lo < 0xD800:
            cleaned.append((lo, 0xD7FF))
        if hi > 0xDFFF:
            cleaned.append((0xE000, hi))
    return tuple(cleaned)


@functools.lru_cache(maxsize=1)
def _category_map() -> dict[str, IntervalSet]:
    """One pass over all codepoints, bucketing by general category."""
    buckets: dict[str, list[int]] = {}
    category = unicodedata.category
    chr_ = chr
    for cp in range(MAX_CP + 1):
        buckets.setdefault(category(chr_(cp)), []).append(cp)
    return {cat: cps_to_intervals(cps) for cat, cps in buckets.items()}


def _apply_overrides(name: str, base: IntervalSet) -> IntervalSet:
    """Patch a two-letter category with the probed deltas between local
    unicodedata and the reference engine's Unicode version (generated by
    scripts/gen_unicode_overrides.py)."""
    from tiktoken_tpu_torch.ops import _unicode_overrides as ov

    added = ov.ADD.get(name)
    removed = ov.REMOVE.get(name)
    if added:
        base = union(base, tuple(added))
    if removed:
        removed_set = tuple(removed)
        base = tuple(
            iv
            for lo, hi in base
            for iv in _subtract_one((lo, hi), removed_set)
        )
    return base


def _subtract_one(iv: Interval, removed: IntervalSet) -> list[Interval]:
    out: list[Interval] = []
    lo, hi = iv
    for rlo, rhi in removed:
        if rhi < lo or rlo > hi:
            continue
        if rlo > lo:
            out.append((lo, rlo - 1))
        lo = rhi + 1
        if lo > hi:
            return out
    out.append((lo, hi))
    return out


@functools.lru_cache(maxsize=None)
def category_set(name: str) -> IntervalSet:
    """Resolve a \\p{...} name to intervals. Supports one-letter groups
    (L, N, M, ...) and two-letter categories (Lu, Nd, ...). Categories are
    corrected to the reference engine's Unicode version via the probed
    override tables."""
    cats = _category_map()
    if name == "Any":
        return ((0, 0xD7FF), (0xE000, MAX_CP))
    if len(name) == 1:
        subs = sorted(cat for cat in set(cats) | {"Lu", "Ll", "Lt", "Lm", "Lo",
                                                  "Mn", "Mc", "Me", "Nd", "Nl", "No"}
                      if cat.startswith(name) and len(cat) == 2)
        return union(*(category_set(sub) for sub in subs))
    if name in cats:
        return _apply_overrides(name, cats[name])
    raise ValueError(f"Unsupported unicode class \\p{{{name}}}")


@functools.lru_cache(maxsize=1)
def white_space_set() -> IntervalSet:
    return cps_to_intervals(WHITE_SPACE_CPS)


@functools.lru_cache(maxsize=1)
def word_set() -> IntervalSet:
    """\\w of the reference engine (UTS#18 word characters), from the
    probed table _unicode_overrides.WORD."""
    from tiktoken_tpu_torch.ops import _unicode_overrides as ov

    return tuple((lo, hi) for lo, hi in ov.WORD)


@functools.lru_cache(maxsize=1)
def dot_set() -> IntervalSet:
    """``.`` outside (?s) mode: any Unicode scalar value except \\n."""
    return ((0, 0x09), (0x0B, 0xD7FF), (0xE000, MAX_CP))


@functools.lru_cache(maxsize=1)
def _fold_groups() -> dict[str, list[int]]:
    """Group codepoints by their single-character full casefold image.

    Approximates the regex engine's simple case folding: for the ASCII
    letters used in the shipped patterns the two coincide (e.g. 's' folds
    together with 'S' and U+017F; 'k' with U+212A).
    """
    groups: dict[str, list[int]] = {}
    for cp in range(MAX_CP + 1):
        folded = chr(cp).casefold()
        if len(folded) == 1:
            groups.setdefault(folded, []).append(cp)
    return groups


def case_fold_class(cps: IntervalSet) -> IntervalSet:
    """Expand a codepoint set to everything that case-folds into it."""
    groups = _fold_groups()
    out = set()
    for lo, hi in cps:
        for cp in range(lo, hi + 1):
            out.add(cp)
            folded = chr(cp).casefold()
            if len(folded) == 1:
                out.update(groups.get(folded, ()))
                out.add(ord(folded))
    return cps_to_intervals(out)


if sys.maxunicode != MAX_CP:  # pragma: no cover
    raise RuntimeError("narrow build not supported")
