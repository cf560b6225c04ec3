"""Spell out numbers in English text (used by the english cleaner).

Behavioral parity with the reference number normalizer
(fs_two/text/numbers.py) without the `inflect` dependency:
a small self-contained cardinal/ordinal speller.
"""

import re

_comma_number_re = re.compile(r"([0-9][0-9,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9.,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ones = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_tens = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_scales = ["", "thousand", "million", "billion", "trillion"]

_ordinal_map = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_thousand(n):
    assert 0 <= n < 1000
    words = []
    if n >= 100:
        words += [_ones[n // 100], "hundred"]
        n %= 100
    if n >= 20:
        words.append(_tens[n // 10])
        if n % 10:
            words.append(_ones[n % 10])
    elif n > 0 or not words:
        words.append(_ones[n])
    return [w for w in words if w]


def number_to_words(n):
    n = int(n)
    if n == 0:
        return "zero"
    groups = []
    idx = 0
    while n > 0:
        n, rem = divmod(n, 1000)
        if rem:
            part = _under_thousand(rem)
            if _scales[idx]:
                part.append(_scales[idx])
            groups.insert(0, " ".join(part))
        idx += 1
    return " ".join(groups)


def ordinal_to_words(n):
    words = number_to_words(n).split(" ")
    last = words[-1]
    if last in _ordinal_map:
        words[-1] = _ordinal_map[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    whole, frac = m.group(1).split(".")
    return number_to_words(whole) + " point " + " ".join(_ones[int(d)] for d in frac)


def _expand_dollars(m):
    match = m.group(1).replace(",", "")
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1].ljust(2, "0")[:2]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        d_unit = "dollar" if dollars == 1 else "dollars"
        c_unit = "cent" if cents == 1 else "cents"
        return "%s %s, %s %s" % (
            number_to_words(dollars), d_unit, number_to_words(cents), c_unit)
    if dollars:
        return "%s %s" % (number_to_words(dollars),
                          "dollar" if dollars == 1 else "dollars")
    if cents:
        return "%s %s" % (number_to_words(cents),
                          "cent" if cents == 1 else "cents")
    return "zero dollars"


def _expand_ordinal(m):
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m):
    n = int(m.group(0))
    if 1000 < n < 3000:
        # Years read in pairs: "nineteen ninety nine".
        if n == 2000:
            return "two thousand"
        if 2000 < n < 2010:
            return "two thousand " + number_to_words(n % 100)
        if n % 100 == 0:
            return number_to_words(n // 100) + " hundred"
        hi, lo = divmod(n, 100)
        lo_words = "oh " + _ones[lo] if lo < 10 else number_to_words(lo)
        return number_to_words(hi) + " " + lo_words
    return number_to_words(n)


def normalize_numbers(text):
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
