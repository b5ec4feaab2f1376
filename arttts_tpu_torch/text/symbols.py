"""Symbol inventory of the GradTTS text path (a copy of
`arttts_tpu/text/symbols.py`, which the port may not import).

pad + special + original punctuation + letters + @ARPAbet; the model's
vocabulary is `len(symbols) + 1` with interspersed blanks.
"""

from arttts_tpu_torch.text.cmudict import VALID_ARPABET

PAD = "_"
PUNCTUATION = "!'(),.:;? \"|"  # extended set used by the ternary path
PUNCTUATION_ORI = "!'(),.:;? "  # original Tacotron set used for symbol ids
SPECIAL = "-"
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

ARPABET = ["@" + s for s in VALID_ARPABET]

symbols = [PAD] + list(SPECIAL) + list(PUNCTUATION_ORI) + list(LETTERS) + ARPABET


def n_symbols_with_blank() -> int:
    """Vocab size including the interspersed blank id (= len(symbols) + 1)."""
    return len(symbols) + 1
