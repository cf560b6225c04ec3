"""Text cleaners, selectable by name in the config.

Same cleaner surface as the reference (fs_two/text/cleaners.py):
``basic_cleaners``, ``transliteration_cleaners``, ``english_cleaners``. The
Russian path uses no cleaners (config ``text_cleaners: []``), so these matter
mainly for the English/lexicon fallback path. ASCII transliteration degrades
gracefully when ``unidecode`` is unavailable.
"""

import re
import unicodedata

from tts_king_torch.text.numbers import normalize_numbers

try:  # optional dependency
    from unidecode import unidecode as _unidecode
except ImportError:  # pragma: no cover
    def _unidecode(text):
        # Strip combining marks, then drop remaining non-ASCII.
        norm = unicodedata.normalize("NFKD", text)
        return "".join(c for c in norm if ord(c) < 128)

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % abbr, re.IGNORECASE), full)
    for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"),
        ("gen", "general"), ("drs", "doctors"), ("rev", "reverend"),
        ("lt", "lieutenant"), ("hon", "honorable"), ("sgt", "sergeant"),
        ("capt", "captain"), ("esq", "esquire"), ("ltd", "limited"),
        ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text):
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text):
    return normalize_numbers(text)


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text):
    return _unidecode(text)


def basic_cleaners(text):
    """Lowercase + collapse whitespace, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text):
    """ASCII transliteration + lowercase + collapse whitespace."""
    return collapse_whitespace(lowercase(convert_to_ascii(text)))


def english_cleaners(text):
    """Full English pipeline: ASCII, lowercase, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)
