"""Corpus phone-label -> IPA tables (the port's copy of
`arttts_tpu/corpora/tables.py`, ref `src/utils_dataset/*.py`).

Factual symbol mappings from the corpora's own documentation (MNGU0 symbol
table, MSPKA Italian phone set, PB2007 French phone set); affricates use tie
bars so the trait embedder sees single segments.
"""

# MNGU0 (British English, .lab files) — mngu0.py:6-57
MNGU0_TO_IPA = {
    "p": "p", "t": "t", "k": "k", "b": "b", "d": "d", "g": "ɡ", "m": "m",
    "n": "n", "N": "ŋ", "T": "θ", "D": "ð", "f": "f", "v": "v", "s": "s",
    "z": "z", "S": "ʃ", "Z": "ʒ", "tS": "t͡ʃ", "dZ": "d͡ʒ", "h": "h",
    "l": "l", "lw": "ɫ", "r": "ɹ", "j": "j", "w": "w", "m!": "m̩",
    "n!": "n̩", "l!": "l̩", "E": "ɛ", "a": "æ", "A": "ɑː", "@@": "ɜ",
    "@U": "əʊ", "Q": "ɒ", "O": "ɔː", "i": "iː", "I": "ɪ", "@": "ə",
    "V": "ʌ", "U": "ʊ", "u": "uː", "eI": "ɛɪ", "aI": "aɪ", "OI": "ɔɪ",
    "aU": "aʊ", "I@": "ɪə", "E@": "ɛə", "U@": "ʊə", "o^": "ɔ̃",
    "#": ".",  # silence -> punctuation token
}

# MSPKA (Italian, .lab files) — mspka.py:6-59
MSPKA_TO_IPA = {
    "a": "a", "e": "e", "E1": "ɛ", "i": "i", "o": "o", "O1": "ɔ", "u": "u",
    "b": "b", "d": "d", "g": "ɡ", "p": "p", "t": "t", "k": "k", "f": "f",
    "v": "v", "s": "s", "z": "z", "SS": "ʃ", "JJ": "ʒ", "m": "m", "n": "n",
    "ng": "ɲ", "l": "l", "r": "ɾ", "j": "j", "w": "w", "dZ": "d͡ʒ",
    "tS": "t͡ʃ", "dz": "d͡z", "ts": "t͡s", "dd": "dː", "tt": "tː",
    "ss": "sː", "pp": "pː", "kk": "kː", "ll": "lː", "rr": "rː", "nn": "nː",
    "mm": "mː", "gg": "ɡː", "vv": "vː", "ddZ": "d͡ʒː", "ddz": "d͡zː",
    "ttS": "t͡ʃː", "tts": "t͡sː", "nf": "nf", "LL": "ʎ", "bb": "bː",
    "ff": "fː", "sil": ".",
}

# PB2007 (French, .phone files) — pb2007.py:7-50
PB2007_TO_IPA = {
    "__": ".", "_": ".",
    "a": "a", "e^": "ɛ", "e": "e", "i": "i", "y": "y", "u": "u",
    "o^": "ɔ", "o": "o", "x": "ø", "x^": "œ", "q": "ə",
    "a~": "ɑ̃", "e~": "ɛ̃", "x~": "œ̃", "o~": "ɔ̃",
    "p": "p", "t": "t", "k": "k", "f": "f", "s": "s", "s^": "ʃ",
    "b": "b", "d": "d", "g": "ɡ", "v": "v", "z": "z", "z^": "ʒ",
    "m": "m", "n": "n", "r": "ʁ", "l": "l", "w": "w", "h": "h", "j": "j",
}

# EMA channel selections (ref utils_ema/cst.py:18-37)
# MSPKA: 21 channels (x,y,z per coil); keep midsagittal x/z of
# ul, ll, li, tt, tm, tb.
MSPKA_EMA_IDX_TO_KEEP = [0, 2, 3, 5, 9, 11, 18, 20, 15, 17, 12, 14]
# PB2007: reorder (li, tt, td, tbck, ul, ll) pairs into SPARC order.
PB2007_IDX_TO_KEEP = [8, 9, 10, 11, 0, 1, 2, 3, 6, 7, 4, 5]
# MOCHA-TIMIT: 20 EMA values (x block then y block per coil); keep
# ul, ll, li, tt, tb, td midsagittal pairs in SPARC order (cst.py:91-117).
MOCHA_IDX_TO_KEEP = [2, 7, 3, 8, 1, 6, 4, 9, 10, 15, 11, 16]

# PB2007 sentence-type split ranges (cst.py:39-68)
PB2007_SPLITS = {
    "vowel": [
        (0, 18), (310, 325), (488, 489), (1086, 1087), (1088, 1089),
        (1090, 1091), (1092, 1093), (1094, 1095),
    ],
    "vcv": [(18, 310), (325, 488), (489, 599)],
    "mono": [(599, 992), (1079, 1080), (1083, 1084)],
    "sentence": [
        (992, 1079), (1080, 1083), (1084, 1086), (1087, 1088), (1089, 1090),
        (1091, 1092), (1093, 1094), (1095, 1109),
    ],
}
