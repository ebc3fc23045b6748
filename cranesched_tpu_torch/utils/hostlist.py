"""Hostlist grammar: "cn[15-18,20]" expansion and compression (the
port's copy of ``cranesched_tpu/utils/hostlist.py``).

The reference implements this in C++ (reference:
src/Utilities/PublicHeader/String.h:88-105 — ``ParseHostList`` and the
regex-compression ``HostNameListToStr``).  The JAX package dispatches to
its native library first; the port carries only the pure-Python
grammar, which gives the same names.  Zero padding is preserved per
group ("cn[01-03]" stays padded)."""

from __future__ import annotations

import re


def _split_top_level(expr: str) -> list[str]:
    out, cur, depth = [], [], 0
    for c in expr:
        if c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        if c == "," and depth == 0:
            if cur:
                out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        out.append("".join(cur))
    return out


def _parse_py(expr: str) -> list[str]:
    names: list[str] = []
    for item in _split_top_level(expr):
        lb = item.find("[")
        if lb < 0:
            if "]" in item:
                raise ValueError(f"malformed hostlist item: {item!r}")
            names.append(item)
            continue
        rb = item.find("]", lb)
        if rb < 0:
            raise ValueError(f"malformed hostlist item: {item!r}")
        prefix, ranges, suffix = item[:lb], item[lb + 1:rb], item[rb + 1:]
        if not ranges:
            raise ValueError(f"empty range in: {item!r}")
        for r in ranges.split(","):
            lo_s, _, hi_s = r.partition("-")
            hi_s = hi_s or lo_s
            if not lo_s.isdigit() or not hi_s.isdigit():
                raise ValueError(f"bad range {r!r} in {item!r}")
            lo, hi = int(lo_s), int(hi_s)
            if hi < lo:
                raise ValueError(f"inverted range {r!r}")
            width = len(lo_s) if lo_s.startswith("0") and len(lo_s) > 1 \
                else 0
            for v in range(lo, hi + 1):
                num = str(v).zfill(width) if width else str(v)
                names.append(f"{prefix}{num}{suffix}")
    return names


_TAIL_NUM = re.compile(r"^(.*?)(\d+)$")


def _compress_py(names: list[str]) -> str:
    groups: dict[tuple[str, int], list[int]] = {}
    order: list[tuple[str, int]] = []
    plain: list[tuple[str, int]] = []  # (name, insertion order marker)
    for name in names:
        m = _TAIL_NUM.match(name)
        if not m:
            key = (name, -1)
            if key not in groups:
                groups[key] = []
                order.append(key)
            continue
        prefix, digits = m.group(1), m.group(2)
        width = len(digits) if digits.startswith("0") and len(digits) > 1 \
            else 0
        key = (prefix, width)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(int(digits))
    parts = []
    for key in order:
        prefix, width = key
        nums = sorted(set(groups[key]))
        if width == -1:
            parts.append(prefix)
            continue

        def fmt(v: int) -> str:
            return str(v).zfill(width) if width else str(v)

        if len(nums) == 1:
            parts.append(f"{prefix}{fmt(nums[0])}")
            continue
        ranges = []
        i = 0
        while i < len(nums):
            j = i
            while j + 1 < len(nums) and nums[j + 1] == nums[j] + 1:
                j += 1
            ranges.append(fmt(nums[i]) if i == j
                          else f"{fmt(nums[i])}-{fmt(nums[j])}")
            i = j + 1
        parts.append(f"{prefix}[{','.join(ranges)}]")
    return ",".join(parts)


def parse_hostlist(expr: str) -> list[str]:
    """Expand a hostlist expression ("cn[01-03],gpu7") to names."""
    if not expr:
        return []
    return _parse_py(expr)


def compress_hostlist(names: list[str]) -> str:
    """Compress names into the bracket grammar ("cn[1-3,5]")."""
    if not names:
        return ""
    return _compress_py(list(names))
