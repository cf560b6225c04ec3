"""Grapheme-to-phoneme frontends (CPU-side string processing).

Equivalent surface to the reference's input_process.py: a Russian G2P path
(external ``russian_g2p`` package when importable, lexicon fallback otherwise),
an English path (lexicon + optional ``g2p_en``), and a lexicon-only path.
All return numpy int arrays of symbol IDs ready for the acoustic model.
"""

import re
from string import punctuation

import numpy as np

from tts_king_torch.text import text_to_sequence

_WORD_SPLIT_RE = re.compile(r"([,;.\-\?\!\s+])")
_LONE_PUNCT_RE = re.compile(r"\{[^\w\s]?\}")

_russian_transcriptor = None
_default_lexicon = None
_default_lexicon_searched = False

# Where a rus_all.dict (the reference's 101k-entry pronunciation lexicon,
# input_process.py:14-23) is looked for when the caller doesn't pass one.
# First hit wins; $TTS_KING_LEXICON overrides everything. Unlike the JAX
# package's list, only paths under the working directory.
LEXICON_SEARCH_PATHS = (
    "./rus_all.dict",
    "./pretrained/rus_all.dict",
)


def find_lexicon():
    """Path of the default pronunciation lexicon, or None.

    $TTS_KING_LEXICON (empty string = disable auto-discovery), then
    LEXICON_SEARCH_PATHS in order."""
    import os

    env = os.environ.get("TTS_KING_LEXICON")
    if env is not None:
        return env if env and os.path.exists(env) else None
    for p in LEXICON_SEARCH_PATHS:
        if os.path.exists(p):
            return p
    return None


def default_lexicon():
    """The auto-discovered lexicon dict (cached), or None when absent."""
    global _default_lexicon, _default_lexicon_searched
    if not _default_lexicon_searched:
        _default_lexicon_searched = True
        path = find_lexicon()
        if path:
            _default_lexicon = read_lexicon(path)
    return _default_lexicon


def read_lexicon(lex_path):
    """Load a ``word phone phone ...`` pronunciation dictionary."""
    lexicon = {}
    with open(lex_path, encoding="utf-8") as f:
        for line in f:
            parts = re.split(r"\s+", line.strip("\n"))
            if not parts:
                continue
            word, phones = parts[0], parts[1:]
            lexicon.setdefault(word.lower(), phones)
    return lexicon


def _phones_to_ids(phones):
    """Join phones into the {..} braces format and convert to IDs."""
    text = "{" + "}{".join(phones) + "}"
    # A lone punctuation phone becomes a short pause.
    text = _LONE_PUNCT_RE.sub("{sp}", text)
    text = text.replace("}{", " ")
    return np.array(text_to_sequence(text, []))


def _get_russian_transcriptor():
    global _russian_transcriptor
    if _russian_transcriptor is None:
        from russian_g2p.Transcription import Transcription  # external package

        _russian_transcriptor = Transcription()
    return _russian_transcriptor


def preprocess_rus(text, lexicon=None):
    """Russian text -> symbol IDs.

    Resolution order (most to least faithful to the reference path,
    input_process.py:71-86):
      1. the external ``russian_g2p`` transcriber when importable;
      2. a pronunciation lexicon (``rus_all.dict``) — the ``lexicon``
         argument, else auto-discovered via :func:`find_lexicon`
         ($TTS_KING_LEXICON / ./rus_all.dict / ./pretrained/ /
         the mounted reference tree) — with the in-tree rule engine
         covering OOV words;
      3. the in-tree rule-based transcriber (text/russian_rules.py, the
         same 54-phone inventory) — zero external dependencies.
    """
    text = text.rstrip(punctuation)
    try:
        transcriptor = _get_russian_transcriptor()
    except ImportError:
        if lexicon is None:
            lexicon = default_lexicon()
        if lexicon is not None:
            return preprocess_with_lexicon(text, lexicon)
        return preprocess_rus_rules(text)
    sentences = transcriptor.transcribe([text])[0]
    phones = [ph for sent in sentences for ph in sent + ["sp"]]
    return _phones_to_ids(phones)


def preprocess_rus_rules(text):
    """Russian text -> symbol IDs via the rule-based transcriber alone.

    Words may carry a '+' before the stressed vowel (``зам+ок`` vs
    ``з+амок``); ё is treated as stressed. The reference's ``sp``
    word-separator convention is kept."""
    from tts_king_torch.text.russian_rules import transcribe

    phones = []
    for word_phones in transcribe(text):
        phones += word_phones + ["sp"]
    if not phones:
        return np.array([], np.int64)
    return _phones_to_ids(phones)


def preprocess_eng(text, lexicon):
    """English text -> symbol IDs via lexicon, with g2p_en fallback per word."""
    text = text.rstrip(punctuation)
    try:
        from g2p_en import G2p  # optional external package

        g2p = G2p()
    except ImportError:
        g2p = None
    phones = []
    for w in _WORD_SPLIT_RE.split(text):
        lw = w.lower()
        if lw in lexicon:
            phones += lexicon[lw]
        elif g2p is not None:
            phones += [p for p in g2p(w) if p != " "]
        elif w.strip():
            phones.append(".")
    return _phones_to_ids(phones)


def preprocess_with_lexicon(text, lexicon):
    """Lexicon path: OOV *Cyrillic* words go through the rule-based
    transcriber (they used to degrade to pauses); anything else becomes a
    pause."""
    from tts_king_torch.text.russian_rules import transcribe

    text = text.rstrip(punctuation)
    phones = []
    for w in _WORD_SPLIT_RE.split(text):
        lw = w.lower().replace("+", "")
        if lw in lexicon:
            phones += lexicon[lw]
        else:
            # '+' stress marks handled by the rule engine; [] if
            # non-Cyrillic. Whitespace/punctuation tokens (the capturing
            # split keeps them) fall through to '.' -> sp, the reference's
            # {sp} word-separator convention (input_process.py:39).
            ruled = transcribe(w)
            phones += ruled[0] if ruled else "."
    return _phones_to_ids(phones)
