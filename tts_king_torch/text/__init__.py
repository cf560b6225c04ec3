"""Text frontend: symbol table and text <-> ID-sequence conversion.

API parity with the reference frontend (fs_two/text/__init__.py):
``text_to_sequence`` parses plain text with ``{...}``-braced phoneme spans and
returns symbol IDs; ``sequence_to_text`` inverts it.
"""

import re

from tts_king_torch.text import cleaners as _cleaners_mod
from tts_king_torch.text.symbols import symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

# text before a {phoneme span}, the span itself, and the rest
_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def text_to_sequence(text, cleaner_names=()):
    """Convert text (optionally with {ARPAbet/phoneme} spans) to symbol IDs."""
    sequence = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(_clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _phonemes_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence):
    """Convert a sequence of symbol IDs back into a readable string."""
    result = ""
    for symbol_id in sequence:
        s = _id_to_symbol.get(int(symbol_id))
        if s is None:
            continue
        if len(s) > 1 and s[0] == "@":
            s = "{%s}" % s[1:]
        result += s
    return result.replace("}{", " ")


def phonemes_to_sequence(phonemes):
    """Convert an iterable of bare phoneme names (no '@') to symbol IDs."""
    return _phonemes_to_sequence(" ".join(phonemes))


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError("Unknown cleaner: %s" % name)
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms):
    return [_symbol_to_id[s] for s in syms if _should_keep_symbol(s)]


def _phonemes_to_sequence(text):
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s):
    return s in _symbol_to_id and s != "_" and s != "~"
