"""Rule-based Russian grapheme-to-phoneme transcription.

Standalone fallback for the external ``russian_g2p`` package the reference
depends on (input_process.py:12): emits the same 54-phoneme inventory
(fs_two/text/russian.py:1-56) so the framework can phonemize arbitrary
Russian text with zero external packages. Russian orthography is largely
regular once stress is known; the rules below implement the standard
phonology the reference lexicon (pretrained/rus_all.dict, 101k
russian_g2p-generated entries) follows:

  * palatalization before е/ё/и/ю/я/ь, with ж/ш/ц always hard and
    ч/щ/й always soft;
  * iotation: я/е/ё/ю word-initially, after vowels and after ь/ъ get J0;
  * single-level vowel reduction: unstressed о,а -> A; е,я -> I
    (Y after hard sibilants); unstressed а after ч/щ -> I; э -> Y/I;
  * regressive voicing assimilation in obstruent clusters + word-final
    devoicing (в devoices but does not voice its neighbors);
  * assimilative palatalization of dentals before soft dentals;
  * cluster rules: сч/зч/жч -> щ, тс/дс/тц/дц/тьс -> ц, стн/здн/лнц/рдц
    simplification, гк -> хк, adjectival -ого/-его -> в, degemination,
    and collapse of identical adjacent vowel phones (аа -> A).

Stress is the one non-determinable input: ``transcribe_word`` takes an
optional stressed-vowel index (letter position). Without it, ё wins if
present, a single-vowel word is stressed on it, otherwise the word is
emitted fully reduced — exactly how the reference lexicon renders words its
accentor could not resolve (~18% of rus_all.dict entries carry no stress).

Validated against a committed 2000-entry sample of rus_all.dict
(tests/test_russian_rules.py).
"""

import re

VOWELS = "аеёиоуыэюя"
# base (hard) consonant phones
_CONS = {
    "б": "B", "в": "V", "г": "G", "д": "D", "ж": "ZH", "з": "Z",
    "й": "J0", "к": "K", "л": "L", "м": "M", "н": "N", "п": "P",
    "р": "R", "с": "S", "т": "T", "ф": "F", "х": "KH", "ц": "TS",
    "ч": "TSH0", "ш": "SH", "щ": "SH0",
    # placeholders introduced by _pre_rules (affrication products):
    "ĉ": "TSH",   # тш/дш -> hard TSH (младший -> M L A0 TSH Y J0)
    "ĝ": "DZH",   # дж -> DZH (пиджак -> P0 I DZH A0 K)
    "ţ": "TS",    # дс/тс -> ц that CAN palatalize (надседаются -> TS0)
    "ẑ": "DZ",    # дз -> DZ that can palatalize (дзержинский -> DZ0)
}
_ALWAYS_HARD = set("жшцĉĝ")
_ALWAYS_SOFT = set("чщй")
_SOFTENERS = set("еёиюяь")

_VOICE = {"P": "B", "F": "V", "K": "G", "T": "D", "SH": "ZH", "S": "Z",
          "TS": "DZ", "TSH": "DZH", "KH": "GH"}
_DEVOICE = {v: k for k, v in _VOICE.items()}
# obstruents that trigger regressive assimilation (в triggers nothing)
_VOICED_TRIGGERS = {"B", "G", "D", "ZH", "Z", "DZ", "DZH", "GH"}
_VOICELESS_TRIGGERS = {"P", "F", "K", "T", "SH", "S", "TS", "TSH", "KH",
                       "SH0"}
_SONORANT_BASES = {"L", "M", "N", "R", "J0"}

# words where final -ого/-его keeps its written г
_OGO_EXCEPTIONS = {
    "много", "немного", "строго", "нестрого", "дорого", "недорого",
    "убого", "пologo", "полого", "отлого", "лого", "ого", "го", "эго",
    "альтер-эго", "сого", "togo", "того-сего",
}
# pronouns/adjectives where non-final ого/его also becomes в
_OGO_WORDS = {"сегодня", "сегодняшний", "итого", "ничего", "чего", "того",
              "кого", "него", "всего", "его"}


def _inventory():
    from tts_king_torch.text.russian import valid_symbols

    return frozenset(valid_symbols)


_INVENTORY = _inventory()


def _is_vowel(ch):
    return ch in VOWELS


def _pre_rules(word):
    """Letter-level rewrites before the main phone pass."""
    w = word
    # reflexive verb endings: тся/ться -> ца
    w = re.sub(r"(?:тся|ться)$", "ца", w)
    # adjectival genitive -ого/-его -> -ово/-ево (with exceptions)
    if (w.endswith("ого") or w.endswith("его")) and len(w) > 3 \
            and w not in _OGO_EXCEPTIONS:
        w = w[:-2] + "в" + w[-1]
    elif w in ("его", "того", "кого", "чего", "ничего", "всего", "него",
               "итого"):
        w = w[:-2] + "в" + w[-1]
    if "сегодня" in w:
        w = w.replace("сегодня", "севодня")

    # щ-clusters
    w = re.sub(r"[сз]ч", "щ", w)
    w = re.sub(r"жч", "щ", w)
    # affricates
    w = re.sub(r"дж", "ĝ", w)
    w = re.sub(r"дз", "ẑ", w)
    w = re.sub(r"[тд]ш", "ĉ", w)
    w = re.sub(r"[тд]ч", "ч", w)
    # ц-clusters (affricatization of dental + ц/с); ţ keeps the ability to
    # palatalize before softeners that written ц lacks
    w = re.sub(r"[тд]ьс", "ţ", w)
    w = re.sub(r"[тд]с", "ţ", w)
    w = re.sub(r"[тд]ц", "ц", w)
    # unpronounceable clusters
    w = re.sub(r"стн", "сн", w)
    w = re.sub(r"здн", "зн", w)
    w = re.sub(r"стл", "сл", w)
    w = re.sub(r"лнц", "нц", w)
    w = re.sub(r"рдц", "рц", w)
    w = re.sub(r"ндш", "нш", w)
    w = re.sub(r"здравств", "здраств", w)
    # г -> х before к (легко, мягко) but -> к before ч (смягчать)
    w = re.sub(r"гк", "хк", w)
    w = re.sub(r"гч", "кч", w)
    # degemination: double consonants collapse
    w = re.sub(r"([бвгджзйклмнпрстфхцчшщ])\1", r"\1", w)
    # voicing-equal pairs also merge (отдать -> A D A0 T0): the voicing
    # pass would assimilate them to a geminate anyway
    w = re.sub(r"т(д[еёиюяь]?)", r"\1", w)
    w = re.sub(r"д(т)", r"\1", w)
    w = re.sub(r"с(з)", r"\1", w)
    w = re.sub(r"з(с)", r"\1", w)
    w = re.sub(r"сш", "ш", w)
    w = re.sub(r"[зс]ж", "ж", w)
    return w


def transcribe_word(word, stress=None):
    """Russian word -> list of phones from the reference 54-phone inventory.

    ``stress``: index INTO ``word`` (original letters, pre-rewrites) of the
    stressed vowel; None for unknown; -1 for explicitly unstressed (clitic
    prepositions/particles). With None: ё is stressed if present, a single
    vowel is stressed, otherwise everything reduces (lexicon convention for
    unresolved stress).
    """
    word = word.lower().replace("-", "")
    if not word or not re.fullmatch(r"[а-яё]+", word):
        return []

    # map the stress index through the letter rewrites by tracking the
    # stressed vowel's ordinal among vowels (rewrites never touch vowels
    # except сегодня, handled coarsely)
    stress_ord = None
    if stress is not None and 0 <= stress < len(word) \
            and _is_vowel(word[stress]):
        stress_ord = sum(1 for c in word[:stress] if _is_vowel(c))
    if stress != -1:
        if stress_ord is None and "ё" in word:
            stress_ord = [c for c in word if _is_vowel(c)].index("ё")
        if stress_ord is None:
            vowels = [c for c in word if _is_vowel(c)]
            if len(vowels) == 1:
                stress_ord = 0

    w = _pre_rules(word)

    phones = []
    n = len(w)
    vowel_i = -1
    for i, ch in enumerate(w):
        nxt = w[i + 1] if i + 1 < n else ""
        prv = w[i - 1] if i > 0 else ""
        if ch in ("ь", "ъ"):
            continue
        if ch in _CONS:
            base = _CONS[ch]
            if ch in _ALWAYS_HARD or ch in _ALWAYS_SOFT:
                phones.append(base)
            elif nxt in _SOFTENERS:
                phones.append(base + "0")
            else:
                phones.append(base)
            continue
        # vowel
        vowel_i += 1
        stressed = (vowel_i == stress_ord)
        iota = (i == 0 or _is_vowel(prv) or prv in ("ь", "ъ"))
        hard_sib = prv in _ALWAYS_HARD
        soft_sib = prv in ("ч", "щ")

        final = (i == n - 1)
        if ch == "а":
            if stressed:
                ph = "A0"
            else:
                # unstressed а after ч/щ reduces to I (часы -> TSH0 I S Y0)
                # except word-finally (матча -> M A0 TSH0 A)
                ph = "I" if (soft_sib and not final) else "A"
            phones.append(ph)
        elif ch == "о":
            if prv == "ь":  # бульон, синьор
                phones.append("J0")
            if stressed:
                phones.append("O0")
            else:
                # like а: unstressed о after ч/щ reduces to I non-finally
                phones.append("I" if (soft_sib and not final) else "A")
        elif ch == "у":
            phones.append("U0" if stressed else "U")
        elif ch == "ы":
            phones.append("Y0" if stressed else "Y")
        elif ch == "э":
            phones.append("E0" if stressed else "Y")
        elif ch == "и":
            if prv == "ь":
                phones.append("J0")
            if hard_sib:
                phones.append("Y0" if stressed else "Y")
            else:
                phones.append("I0" if stressed else "I")
        elif ch == "е":
            if iota:
                phones.append("J0")
            if hard_sib:
                phones.append("E0" if stressed else "Y")
            else:
                phones.append("E0" if stressed else "I")
        elif ch == "ё":
            if iota:
                phones.append("J0")
            # ё is O-quality and normally carries the stress (днём ->
            # D N0 O0 M); when another vowel is explicitly stressed it
            # stays unreduced O (четырёхугольники -> ... R0 O KH U G O0 ...)
            phones.append("O0" if stressed else "O")
        elif ch == "ю":
            if iota:
                phones.append("J0")
            phones.append("U0" if stressed else "U")
        elif ch == "я":
            if iota:
                phones.append("J0")
            if stressed:
                phones.append("A0")
            else:
                # word-final unstressed я stays open (задняя -> ... J0 A,
                # -ся -> S0 A); elsewhere it reduces to I
                phones.append("A" if final else "I")

    phones = _voicing_pass(phones)
    phones = _collapse_geminates(phones)
    phones = _softness_pass(phones)
    phones = _collapse_vowels(phones)
    # inventory guard: voicing of a soft х would give GH0, which the
    # 54-phone set lacks — degrade to the hard variant (never reachable in
    # normal text; belt and braces for the symbol-ID contract)
    return [p if p in _INVENTORY else _strip_soft(p) for p in phones]


_VOWEL_BASES = {"A", "E", "I", "O", "U", "Y"}


def _collapse_geminates(phones):
    """Same-base adjacent consonants merge after voicing assimilation
    (пакгаузов: K G -> G G -> G; тьте: T0 T0 -> T0), keeping the softer."""
    out = []
    for p in phones:
        if out and p != "J0" and out[-1] != "J0" \
                and _strip_soft(p) not in _VOWEL_BASES \
                and _strip_soft(out[-1]) == _strip_soft(p):
            if p.endswith("0"):
                out[-1] = p
            continue
        out.append(p)
    return out


def _strip_soft(p):
    return p[:-1] if p.endswith("0") and p not in ("J0",) else p


def _is_obstruent(p):
    b = _strip_soft(p)
    return b in _VOICE or b in _DEVOICE or b in ("V",)


def _voicing_pass(phones):
    """Right-to-left regressive voicing assimilation + final devoicing."""
    out = list(phones)
    n = len(out)

    def set_voice(i, voiced):
        p = out[i]
        soft = p.endswith("0") and p != "J0" and len(p) > 1 and \
            _strip_soft(p) in (set(_VOICE) | set(_DEVOICE) | {"V"})
        b = _strip_soft(p) if soft else p
        if voiced and b in _VOICE:
            out[i] = _VOICE[b] + ("0" if soft else "")
        elif not voiced and b in _DEVOICE:
            out[i] = _DEVOICE[b] + ("0" if soft else "")
        elif not voiced and b == "V":
            out[i] = "F" + ("0" if soft else "")

    # find, for each obstruent, the voicing demanded by what follows
    for i in range(n - 1, -1, -1):
        p = out[i]
        b = _strip_soft(p)
        if not _is_obstruent(p):
            continue
        # look at the next phone (vowels/sonorants break the chain)
        if i == n - 1:
            set_voice(i, False)  # word-final devoicing
            continue
        nb = _strip_soft(out[i + 1])
        if nb in _VOICED_TRIGGERS and nb != "V":
            set_voice(i, True)
        elif nb in _VOICELESS_TRIGGERS or nb == "F":
            set_voice(i, False)
        elif nb == "V":
            # в devoices a preceding obstruent only word-finally... it
            # does not trigger assimilation at all; keep as written
            pass
        del b
    return out


def _softness_pass(phones):
    """Assimilative palatalization, fit to the reference lexicon:
    с/з soften before soft dentals (сделать -> Z0 D0, снег -> S0 N0 — but
    NOT before L0: если -> S L0); н softens before soft dentals and ч/щ
    (зонтик -> N0 T0, женщина -> N0 SH0); т/д do not assimilate
    (задняя -> Z A0 D N0 I J0 A). Right-to-left so chains propagate."""
    out = list(phones)
    for i in range(len(out) - 2, -1, -1):
        p, nxt = out[i], out[i + 1]
        if p in ("S", "Z") and nxt in ("T0", "D0", "N0", "S0", "Z0"):
            out[i] = p + "0"
        elif p == "N" and nxt in ("T0", "D0", "S0", "Z0", "N0",
                                  "TSH0", "SH0"):
            out[i] = "N0"
    return out


def _collapse_vowels(phones):
    """Identical adjacent UNSTRESSED vowel phones merge (аа -> A,
    решении -> ... N0 I); a stressed one keeps its neighbor
    (психиатрии -> ... R0 I0 I)."""
    out = []
    for p in phones:
        if out and p in _VOWEL_BASES and out[-1] == p:
            continue
        out.append(p)
    return out


def transcribe(text, stress_marks=False):
    """Text -> list of per-word phone lists. Words may carry a '+' before
    the stressed vowel (``прив+ет``) when the caller knows stress."""
    words = re.findall(r"[а-яёА-ЯЁ+\-]+", text)
    result = []
    for word in words:
        stress = None
        if "+" in word:
            pos = word.index("+")
            word = word.replace("+", "")
            if pos < len(word):
                stress = pos
        phones = transcribe_word(word, stress=stress)
        if phones:
            result.append(phones)
    return result
