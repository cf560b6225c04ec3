"""Russian phoneme inventory.

Same 54-symbol set the reference uses (see fs_two/text/russian.py:1-56):
a russian_g2p-style inventory with hard/soft (``0``-suffixed) consonant and
stressed-vowel variants.
"""

# "0"-suffix marks palatalized consonants / stressed vowels. Order matters:
# symbol IDs are positional and must line up with reference checkpoints.
valid_symbols = [
    "A", "A0",
    "B", "B0",
    "D", "D0",
    "DZ", "DZ0",
    "DZH", "DZH0",
    "E0",
    "F", "F0",
    "G", "G0",
    "GH",
    "I", "I0",
    "J0",
    "K", "K0",
    "KH", "KH0",
    "L", "L0",
    "M", "M0",
    "N", "N0",
    "O", "O0",
    "P", "P0",
    "R", "R0",
    "S", "S0",
    "SH", "SH0",
    "T", "T0",
    "TS", "TS0",
    "TSH", "TSH0",
    "U", "U0",
    "V", "V0",
    "Y", "Y0",
    "Z", "Z0",
    "ZH",
]
