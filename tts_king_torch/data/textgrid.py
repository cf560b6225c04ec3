"""Minimal Praat TextGrid reader (long + short formats, IntervalTiers).

Port of tts_king_tpu/data/textgrid.py (the same code). It replaces the
reference's external `tgt` dependency (preprocessor.py:5,190): only what MFA
alignment output needs, tiers with named intervals.
"""

import re
from dataclasses import dataclass
from typing import List


@dataclass
class Interval:
    start_time: float
    end_time: float
    text: str


@dataclass
class Tier:
    name: str
    intervals: List[Interval]


@dataclass
class TextGrid:
    tiers: List[Tier]

    def get_tier_by_name(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}")


_NUM_RE = re.compile(r"(xmin|xmax)\s*=\s*([0-9.eE+-]+)")
_TEXT_RE = re.compile(r'text\s*=\s*"(.*)"\s*$')
_NAME_RE = re.compile(r'name\s*=\s*"(.*)"\s*$')
_CLASS_RE = re.compile(r'class\s*=\s*"(.*)"\s*$')


def read_textgrid(path: str) -> TextGrid:
    with open(path, encoding="utf-8") as f:
        content = f.read()
    if '"IntervalTier"' in content and "item" in content:
        return _read_long(content)
    return _read_short(content)


def _read_long(content: str) -> TextGrid:
    tiers = []
    cur = None
    pending = {}
    in_intervals = False
    for raw in content.splitlines():
        line = raw.strip()
        m = _CLASS_RE.search(line)
        if m:
            cur = Tier(name="", intervals=[]) if m.group(1) == "IntervalTier" else None
            if cur is not None:
                tiers.append(cur)
            in_intervals = False
            continue
        if cur is None:
            continue
        m = _NAME_RE.search(line)
        if m and not in_intervals:
            cur.name = m.group(1)
            continue
        if line.startswith("intervals"):
            in_intervals = True
            if re.match(r"intervals\s*\[", line):
                pending = {}
            continue
        if in_intervals:
            m = _NUM_RE.search(line)
            if m:
                pending[m.group(1)] = float(m.group(2))
                continue
            m = _TEXT_RE.search(line)
            if m:
                cur.intervals.append(Interval(
                    pending.get("xmin", 0.0), pending.get("xmax", 0.0),
                    m.group(1)))
                pending = {}
    return TextGrid(tiers)


def _read_short(content: str) -> TextGrid:
    """Short ("ooTextFile short") format: values on bare lines."""
    lines = [l.strip() for l in content.splitlines() if l.strip()]
    tiers = []
    i = 0
    # header: File type, Object class, xmin, xmax, <exists>, ntiers
    while i < len(lines) and lines[i] != "<exists>":
        i += 1
    if i == len(lines):
        raise ValueError("not a short TextGrid")
    i += 1
    n_tiers = int(lines[i]); i += 1
    for _ in range(n_tiers):
        klass = lines[i].strip('"'); i += 1
        name = lines[i].strip('"'); i += 1
        i += 2  # tier xmin, xmax
        n_int = int(lines[i]); i += 1
        tier = Tier(name=name, intervals=[])
        for _ in range(n_int):
            a = float(lines[i]); b = float(lines[i + 1])
            text = lines[i + 2].strip('"')
            i += 3
            tier.intervals.append(Interval(a, b, text))
        if klass == "IntervalTier":
            tiers.append(tier)
    return TextGrid(tiers)
