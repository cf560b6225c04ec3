"""The model's input symbol table.

206 symbols in the same positional order as the reference
(fs_two/text/symbols.py:23-32): pad, '-', punctuation, ASCII
letters, 84 @-prefixed ARPAbet symbols, 3 silence markers, 54 @-prefixed
Russian phonemes, and the @mask token used for grapheme masking.

Order is load-bearing: phoneme IDs are positions in this list, and converted
reference checkpoints index their embedding tables by these IDs.

The reference also ships a pinyin symbol inventory
(fs_two/text/pinyin.py) but comments it OUT of the table
(symbols.py:29 `# + _pinyin`), so it contributes no IDs and is dead at
runtime; it is deliberately not ported — adding it would shift every
Russian phoneme ID and break checkpoint parity.
"""

from tts_king_torch.text import cmudict, russian

PAD = "_"
MASK = "mask"

_punctuation = "!'(),.:;? "
_special = "-"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

SILENCES = ["@sp", "@spn", "@sil"]

# "@" prefix keeps single-letter phonemes distinct from raw characters.
_arpabet = ["@" + s for s in cmudict.valid_symbols]
_russian = ["@" + s for s in russian.valid_symbols + [MASK]]

symbols = (
    [PAD]
    + list(_special)
    + list(_punctuation)
    + list(_letters)
    + _arpabet
    + SILENCES
    + _russian
)

# Embedding-table size: one extra row, mirroring the reference's
# `len(symbols) + 1` vocab (fs_two/transformer/Models.py:40).
VOCAB_SIZE = len(symbols) + 1
