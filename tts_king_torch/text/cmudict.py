"""ARPAbet phoneme inventory (standard CMUdict set with stress markers).

Matches the symbol set used by the reference English path
(fs_two/text/cmudict.py) so symbol IDs line up.
"""

import re

valid_symbols = [
    "AA", "AA0", "AA1", "AA2",
    "AE", "AE0", "AE1", "AE2",
    "AH", "AH0", "AH1", "AH2",
    "AO", "AO0", "AO1", "AO2",
    "AW", "AW0", "AW1", "AW2",
    "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH",
    "EH", "EH0", "EH1", "EH2",
    "ER", "ER0", "ER1", "ER2",
    "EY", "EY0", "EY1", "EY2",
    "F", "G", "HH",
    "IH", "IH0", "IH1", "IH2",
    "IY", "IY0", "IY1", "IY2",
    "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2",
    "OY", "OY0", "OY1", "OY2",
    "P", "R", "S", "SH", "T", "TH",
    "UH", "UH0", "UH1", "UH2",
    "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
]

_valid_symbol_set = set(valid_symbols)

_alt_re = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Thin wrapper around a CMUdict-formatted pronunciation lexicon."""

    def __init__(self, path, keep_ambiguous=True):
        entries = {}
        with open(path, encoding="latin-1") as f:
            for line in f:
                if len(line) and (line[0] >= "A" and line[0] <= "Z" or line[0] == "'"):
                    parts = line.split("  ")
                    if len(parts) != 2:
                        continue
                    word = _alt_re.sub("", parts[0])
                    pron = _parse_pronunciation(parts[1])
                    if pron is not None:
                        entries.setdefault(word, []).append(pron)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        """Return list of ARPAbet pronunciation strings for a word, or None."""
        return self._entries.get(word.upper())


def _parse_pronunciation(s):
    parts = s.strip().split(" ")
    for part in parts:
        if part not in _valid_symbol_set:
            return None
    return " ".join(parts)
