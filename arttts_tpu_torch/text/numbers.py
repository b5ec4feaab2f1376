"""English number normalization without external deps (a copy of
`arttts_tpu/text/numbers.py`).

Behavioral equivalent of the reference's inflect-based normalizer
(`src/text/numbers.py`): comma removal, pounds/dollars, decimal points,
ordinals, and year-style reading of 1000<n<3000 with `group(2)` pairs.
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def number_to_words(n: int, andword: str = "and") -> str:
    """Integer to English words, inflect-style ('one hundred and one')."""
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n < 100:
        return _two_digits(n)
    for scale, name in _SCALES:
        if n >= scale:
            head = number_to_words(n // scale, andword)
            rest = n % scale
            if rest == 0:
                return f"{head} {name}"
            joiner = f" {andword} " if (rest < 100 and andword) else " "
            if rest < 100 and not andword:
                joiner = " "
            return f"{head} {name}{joiner}{number_to_words(rest, andword)}"
    return _two_digits(n)


def number_to_ordinal_words(n: int) -> str:
    words = number_to_words(n)
    # ordinalize the final word
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    hyph = last.rsplit("-", 1)
    final = hyph[-1]
    if final in _ORDINAL_IRREGULAR:
        final_ord = _ORDINAL_IRREGULAR[final]
    elif final.endswith("y"):
        final_ord = final[:-1] + "ieth"
    else:
        final_ord = final + "th"
    hyph[-1] = final_ord
    parts[-1] = "-".join(hyph)
    return " ".join(parts)


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    elif dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    elif cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m):
    return number_to_ordinal_words(int(m.group(0)[:-2]))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + _two_digits(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100, andword="") + " hundred"
        # year-style pairs: 1864 -> "eighteen sixty-four"
        hi, lo = divmod(num, 100)
        lo_words = "oh " + _ONES[lo] if lo < 10 and lo > 0 else _two_digits(lo)
        return f"{number_to_words(hi, andword='')} {lo_words}"
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    text = _comma_number_re.sub(_remove_commas, text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal_point, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text
