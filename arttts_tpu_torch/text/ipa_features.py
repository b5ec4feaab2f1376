"""IPA segment -> ternary phonological trait vectors (the port's copy of
`arttts_tpu/text/ipa_features.py`: the trait table is data, copied here
because the port may not import the JAX package).

The reference derives 24-dim ternary (+1/0/-1) trait vectors from panphon's
`FeatureTable.word_array` (`src/text/converters.py:26-55`). panphon is not
available here, so this module implements a native feature table following the
same Hayes-style feature system and the same trait ordering
(`converters.py:29-54`):

    syl son cons cont delrel lat nas strid voi sg cg ant cor distr lab
    hi lo back round velaric tense long hitone hireg

The table is keyed by IPA segment string (combining tie bars included, e.g.
"t͡ʃ"). The rhotacization modifier "˞" is applied as a diacritic (sets +cor).
Values are chosen so every segment in the supported inventory maps to a
distinct vector; models in this framework are trained from scratch on these
embeddings, so internal consistency (not bit-parity with panphon) is the
contract. Extend `SEGMENTS` for additional language inventories — or swap
the whole table for panphon's actual values with `load_table(path)` (e.g.
panphon's `ipa_all.csv`) to restore reference-trained ipa_trait checkpoint
parity; see MIGRATION.md.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

TRAITS: List[str] = [
    "syl", "son", "cons", "cont", "delrel", "lat", "nas", "strid", "voi",
    "sg", "cg", "ant", "cor", "distr", "lab", "hi", "lo", "back", "round",
    "velaric", "tense", "long", "hitone", "hireg",
]
N_TRAITS = len(TRAITS)

_BASE = {t: 0 for t in TRAITS}


def _seg(**kw) -> Dict[str, int]:
    d = dict(_BASE)
    d.update(kw)
    return d


def _vowel(hi, lo, back, rnd, tense, **kw):
    d = _seg(
        syl=1, son=1, cons=-1, cont=1, delrel=-1, lat=-1, nas=-1, strid=0,
        voi=1, sg=-1, cg=-1, ant=0, cor=-1, distr=0,
        lab=1 if rnd > 0 else -1,
        hi=hi, lo=lo, back=back, round=rnd, velaric=-1, tense=tense,
        long=-1, hitone=0, hireg=0,
    )
    d.update(kw)
    return d


def _cons(**kw):
    d = _seg(
        syl=-1, son=-1, cons=1, cont=-1, delrel=-1, lat=-1, nas=-1, strid=0,
        voi=-1, sg=-1, cg=-1, ant=0, cor=-1, distr=0, lab=-1, hi=-1, lo=-1,
        back=-1, round=-1, velaric=-1, tense=0, long=-1, hitone=0, hireg=0,
    )
    d.update(kw)
    return d


SEGMENTS: Dict[str, Dict[str, int]] = {
    # --- vowels -----------------------------------------------------------
    "i": _vowel(1, -1, -1, -1, 1),
    "ɪ": _vowel(1, -1, -1, -1, -1),
    "e": _vowel(-1, -1, -1, -1, 1),
    "ɛ": _vowel(-1, -1, -1, -1, -1),
    "æ": _vowel(-1, 1, -1, -1, -1),
    "a": _vowel(-1, 1, -1, -1, 1),
    "ɑ": _vowel(-1, 1, 1, -1, -1),
    "ɒ": _vowel(-1, 1, 1, 1, -1),
    "ɔ": _vowel(-1, -1, 1, 1, -1),
    "o": _vowel(-1, -1, 1, 1, 1),
    "ʊ": _vowel(1, -1, 1, 1, -1),
    "u": _vowel(1, -1, 1, 1, 1),
    "ə": _vowel(-1, -1, 0, -1, 0),
    "ʌ": _vowel(-1, -1, 1, -1, -1),
    "ɜ": _vowel(-1, -1, 0, -1, -1),
    "ɐ": _vowel(-1, 1, 0, -1, -1),
    "y": _vowel(1, -1, -1, 1, 1),
    "ø": _vowel(-1, -1, -1, 1, 1),
    "œ": _vowel(-1, -1, -1, 1, -1),
    "ɯ": _vowel(1, -1, 1, -1, 1),
    "ɨ": _vowel(1, -1, 0, -1, 1),
    "ʉ": _vowel(1, -1, 0, 1, 1),
    "ɤ": _vowel(-1, -1, 1, -1, 1),  # Mandarin e
    # --- glides -----------------------------------------------------------
    "w": _cons(son=1, cons=-1, cont=1, voi=1, lab=1, round=1, hi=1, back=1),
    "j": _cons(son=1, cons=-1, cont=1, voi=1, hi=1, back=-1),
    "ɥ": _cons(son=1, cons=-1, cont=1, voi=1, lab=1, round=1, hi=1, back=-1),
    # --- liquids ----------------------------------------------------------
    "l": _cons(son=1, cont=1, lat=1, voi=1, ant=1, cor=1, distr=-1),
    "ɫ": _cons(son=1, cont=1, lat=1, voi=1, ant=1, cor=1, distr=-1, hi=1, back=1),
    "ɹ": _cons(son=1, cont=1, voi=1, ant=-1, cor=1, distr=-1),
    "ɾ": _cons(son=1, cont=-1, voi=1, ant=1, cor=1, distr=-1),
    "r": _cons(son=1, cont=1, voi=1, ant=1, cor=1, distr=-1, strid=-1),
    "ʁ": _cons(cont=1, voi=1, ant=-1, back=1, hi=-1, strid=1),
    "ʎ": _cons(son=1, cont=1, lat=1, voi=1, ant=-1, cor=1, distr=1, hi=1),
    # --- nasals -----------------------------------------------------------
    "m": _cons(son=1, nas=1, voi=1, lab=1, ant=1),
    "n": _cons(son=1, nas=1, voi=1, ant=1, cor=1, distr=-1),
    "ŋ": _cons(son=1, nas=1, voi=1, ant=-1, hi=1, back=1),
    "ɲ": _cons(son=1, nas=1, voi=1, ant=-1, cor=1, distr=1, hi=1),
    # --- stops ------------------------------------------------------------
    "p": _cons(lab=1, ant=1),
    "b": _cons(voi=1, lab=1, ant=1),
    "t": _cons(ant=1, cor=1, distr=-1),
    "d": _cons(voi=1, ant=1, cor=1, distr=-1),
    "ʈ": _cons(ant=-1, cor=1, distr=-1),
    "ɖ": _cons(voi=1, ant=-1, cor=1, distr=-1),
    "c": _cons(ant=-1, cor=1, distr=1, hi=1),
    "ɟ": _cons(voi=1, ant=-1, cor=1, distr=1, hi=1),
    "k": _cons(ant=-1, hi=1, back=1),
    "ɡ": _cons(voi=1, ant=-1, hi=1, back=1),
    "g": _cons(voi=1, ant=-1, hi=1, back=1),
    "q": _cons(ant=-1, hi=-1, back=1),
    "ʔ": _cons(cg=1, ant=-1),
    # --- fricatives -------------------------------------------------------
    "f": _cons(cont=1, strid=1, lab=1, ant=1),
    "v": _cons(cont=1, strid=1, voi=1, lab=1, ant=1),
    "θ": _cons(cont=1, strid=-1, ant=1, cor=1, distr=1),
    "ð": _cons(cont=1, strid=-1, voi=1, ant=1, cor=1, distr=1),
    "s": _cons(cont=1, strid=1, ant=1, cor=1, distr=-1),
    "z": _cons(cont=1, strid=1, voi=1, ant=1, cor=1, distr=-1),
    "ʃ": _cons(cont=1, strid=1, ant=-1, cor=1, distr=1),
    "ʒ": _cons(cont=1, strid=1, voi=1, ant=-1, cor=1, distr=1),
    "ʂ": _cons(cont=1, strid=1, ant=-1, cor=1, distr=-1),
    "ʐ": _cons(cont=1, strid=1, voi=1, ant=-1, cor=1, distr=-1),
    "ɕ": _cons(cont=1, strid=1, ant=-1, cor=1, distr=1, hi=1),
    "ʑ": _cons(cont=1, strid=1, voi=1, ant=-1, cor=1, distr=1, hi=1),
    "ç": _cons(cont=1, strid=-1, ant=-1, hi=1, back=-1),
    "x": _cons(cont=1, strid=-1, ant=-1, hi=1, back=1),
    "ɣ": _cons(cont=1, strid=-1, voi=1, ant=-1, hi=1, back=1),
    "χ": _cons(cont=1, strid=1, ant=-1, hi=-1, back=1),
    "h": _cons(son=-1, cons=-1, cont=1, sg=1, ant=-1),
    "ɦ": _cons(son=-1, cons=-1, cont=1, sg=1, voi=1, ant=-1),
    # --- affricates -------------------------------------------------------
    "t͡ʃ": _cons(delrel=1, strid=1, ant=-1, cor=1, distr=1),
    "d͡ʒ": _cons(delrel=1, strid=1, voi=1, ant=-1, cor=1, distr=1),
    "t͡s": _cons(delrel=1, strid=1, ant=1, cor=1, distr=-1),
    "d͡z": _cons(delrel=1, strid=1, voi=1, ant=1, cor=1, distr=-1),
    "t͡ɕ": _cons(delrel=1, strid=1, ant=-1, cor=1, distr=1, hi=1),
    "d͡ʑ": _cons(delrel=1, strid=1, voi=1, ant=-1, cor=1, distr=1, hi=1),
    "ʈ͡ʂ": _cons(delrel=1, strid=1, ant=-1, cor=1, distr=-1),
    "ɖ͡ʐ": _cons(delrel=1, strid=1, voi=1, ant=-1, cor=1, distr=-1),
    # --- additional consonants for broad CommonVoice coverage ------------
    "ɸ": _cons(cont=1, strid=-1, lab=1, ant=1),            # bilabial fric
    "β": _cons(cont=1, strid=-1, voi=1, lab=1, ant=1),
    "ʋ": _cons(son=1, cont=1, voi=1, lab=1, ant=1, strid=-1),  # labiodental appr
    "ɰ": _cons(son=1, cons=-1, cont=1, voi=1, hi=1, back=1, strid=-1),
    "ɭ": _cons(son=1, cont=1, lat=1, voi=1, ant=-1, cor=1, distr=-1),  # retroflex l
    "ɳ": _cons(son=1, nas=1, voi=1, ant=-1, cor=1, distr=-1),  # retroflex n
    "ɽ": _cons(son=1, cont=-1, voi=1, ant=-1, cor=1, distr=-1),  # retroflex flap
    "ɴ": _cons(son=1, nas=1, voi=1, ant=-1, hi=-1, back=1),  # uvular nasal
    "ɢ": _cons(voi=1, ant=-1, hi=-1, back=1),               # uvular stop
    "ħ": _cons(son=-1, cons=1, cont=1, sg=-1, ant=-1, lo=1, back=1),  # pharyngeal
    "ʕ": _cons(son=-1, cons=1, cont=1, voi=1, ant=-1, lo=1, back=1),
    "ɬ": _cons(cont=1, lat=1, strid=1, ant=1, cor=1, distr=-1),  # lateral fric
    "ɮ": _cons(cont=1, lat=1, strid=1, voi=1, ant=1, cor=1, distr=-1),
    "ɹ̠": _cons(son=1, cont=1, voi=1, ant=-1, cor=1, distr=1),
    # implosives: constricted glottis + voicing
    "ɓ": _cons(voi=1, cg=1, lab=1, ant=1),
    "ɗ": _cons(voi=1, cg=1, ant=1, cor=1, distr=-1),
    "ɠ": _cons(voi=1, cg=1, ant=-1, hi=1, back=1),
    # clicks: velaric airstream
    "ʘ": _cons(velaric=1, lab=1, ant=1),
    "ǀ": _cons(velaric=1, ant=1, cor=1, distr=1),
    "ǃ": _cons(velaric=1, ant=-1, cor=1, distr=-1),
    "ǂ": _cons(velaric=1, ant=-1, cor=1, distr=1),
    "ǁ": _cons(velaric=1, lat=1, ant=1, cor=1, distr=-1),
    # --- long-tail consonants (r5 tranche: VoxCommunis MFA long tail) -----
    "ʙ": _cons(son=1, cont=1, voi=1, lab=1, ant=1),          # bilabial trill
    "ⱱ": _cons(son=1, cont=-1, voi=1, lab=1, ant=1, strid=1),  # labiodental flap
    "ɺ": _cons(son=1, cont=-1, lat=1, voi=1, ant=1, cor=1, distr=-1),  # lateral flap
    "ʜ": _cons(son=-1, cons=1, cont=1, ant=-1, lo=1, back=1, strid=1),  # epiglottal fric
    "ʢ": _cons(son=-1, cons=1, cont=1, voi=1, ant=-1, lo=1, back=1, strid=1),
    "ʡ": _cons(cg=1, ant=-1, lo=1, back=1),                  # epiglottal stop
    "ɧ": _cons(cont=1, strid=1, ant=-1, cor=1, distr=1, hi=1, back=1, lab=1),  # Swedish sj
    # --- additional consonants (msml1h language sweep) ---------------------
    "ɱ": _cons(son=1, nas=1, voi=1, lab=1, ant=1, strid=1),  # labiodental nasal
    "ʀ": _cons(son=1, cont=1, voi=1, ant=-1, hi=-1, back=1),  # uvular trill
    "ʝ": _cons(cont=1, strid=-1, voi=1, ant=-1, hi=1, back=-1),  # voiced palatal fric
    "ɻ": _cons(son=1, cont=1, voi=1, ant=-1, cor=1, distr=-1, strid=-1),  # retroflex appr
    "ʍ": _cons(son=1, cons=-1, cont=1, lab=1, round=1, hi=1, back=1),  # voiceless w
    "t͡ɬ": _cons(delrel=1, lat=1, strid=-1, ant=1, cor=1, distr=-1),  # lateral affricate
    "k͡p": _cons(ant=-1, lab=1, hi=1, back=1),  # labial-velar stop
    "ɡ͡b": _cons(voi=1, ant=-1, lab=1, hi=1, back=1),
    "g͡b": _cons(voi=1, ant=-1, lab=1, hi=1, back=1),
    "p͡f": _cons(delrel=1, strid=1, lab=1, ant=1),  # German labiodental affricate
    "c͡ç": _cons(delrel=1, strid=-1, ant=-1, hi=1, back=-1),
    "ɟ͡ʝ": _cons(delrel=1, strid=-1, voi=1, ant=-1, hi=1, back=-1),
    # --- additional vowels -----------------------------------------------
    "ɶ": _vowel(-1, 1, -1, 1, -1),
    "ʏ": _vowel(1, -1, -1, 1, -1),
    "ɵ": _vowel(-1, -1, 0, 1, 1),
    "ɘ": _vowel(-1, -1, 0, -1, 1),
    "ɞ": _vowel(-1, -1, 0, 1, -1),
    "ʚ": _vowel(-1, -1, 0, 1, -1, strid=1),  # closed-epsilon variant of ɞ
    "ɪ̈": _vowel(1, -1, 0, -1, -1),
    "ə̯": _vowel(-1, -1, 0, -1, 0, syl=-1),  # non-syllabic schwa
    "ɚ": _vowel(-1, -1, 0, -1, 0, cor=1),  # rhotacized schwa (== "ə˞")
    "ɝ": _vowel(-1, -1, 0, -1, -1, cor=1),  # rhotacized open-mid central
    # --- tone letters (zh-CN and other tonal corpora): only the tonal
    # traits are marked; "˧" (mid) is the all-zero vector used as the
    # multilingual silence representative (voxcommunis/decoder.py).
    "˥": _seg(hitone=1, hireg=1),
    "˦": _seg(hitone=1, hireg=-1),
    "˧": _seg(),
    "˨": _seg(hitone=-1, hireg=1),
    "˩": _seg(hitone=-1, hireg=-1),
}

# Diacritic modifiers applied to a base segment (suffix characters).
_MODIFIERS = {
    "˞": {"cor": 1},        # rhotacization (ER/ER0 -> "ɜ˞"/"ə˞")
    "ː": {"long": 1},       # length
    "ˑ": {"long": 1},       # half-long
    "̃": {"nas": 1},         # nasalization (combining tilde)
    "ʰ": {"sg": 1},         # aspiration
    "ʱ": {"sg": 1},         # breathy-voiced aspiration (Hindi/Marathi/...)
    "̥": {"voi": -1},        # devoicing (combining ring below)
    "̊": {"voi": -1},        # devoicing (combining ring above)
    "ʲ": {"hi": 1},         # palatalization
    "̩": {"syl": 1},         # syllabic consonant (MNGU0 m!/n!/l!)
    "ʷ": {"round": 1, "lab": 1},  # labialization
    "ʼ": {"cg": 1},          # ejective (Georgian/Amharic/...)
    "̪": {"distr": 1},        # dental
    "̺": {"distr": -1},       # apical
    "̻": {"distr": 1},        # laminal
    "̠": {"ant": -1},         # retracted
    "̟": {"ant": 1},          # advanced
    "̯": {"syl": -1},         # non-syllabic
    "ˤ": {"lo": 1, "back": 1},  # pharyngealization (Arabic emphatics)
    "̴": {"hi": 1, "back": 1},  # velarization
    "̰": {"cg": 1},           # creaky voice (Vietnamese)
    "̤": {"sg": 1},           # breathy voice
    "ⁿ": {"nas": 1},          # prenasalization
    "˺": {},                  # unreleased (no featural change)
    "̆": {},                  # extra-short
    "̑": {},                  # combining inverted breve (extra-short variant)
    "̝": {},                  # raised
    "̞": {},                  # lowered
    "ᵊ": {},                  # epenthetic schwa release
    "̈": {"back": 0},         # centralized (combining diaeresis, e.g. ä)
    "̽": {"back": 0},         # mid-centralized
    "̍": {"syl": 1},          # syllabic (combining line above, e.g. ŋ̍)
    "ˡ": {"lat": 1},          # lateral release
    # tone accents on vowels (African/tonal CommonVoice corpora)
    "́": {"hitone": 1},                 # acute: high tone
    "̀": {"hitone": -1},                # grave: low tone
    "̄": {},                            # macron: mid tone
    "̂": {"hitone": 1, "hireg": -1},    # circumflex: falling contour
    "̌": {"hitone": -1, "hireg": 1},    # caron: rising contour
}

# Prefix modifiers (applied from the LEFT of the base segment): superscript
# prenasalization (Bantu ᵐb/ⁿd/ᵑɡ) and click accompaniments (ᵏǃ/ᶢǀ).
_PREFIX_MODIFIERS = {
    "ᵐ": {"nas": 1},
    "ⁿ": {"nas": 1},
    "ᵑ": {"nas": 1},
    "ᶮ": {"nas": 1},
    "ᵏ": {},
    "ᶢ": {"voi": 1},
}

# Transparent characters inside phone strings: stress/syllable/boundary
# marks carry no segmental features (the reference's panphon tokenization
# drops them the same way).
_SKIP_CHARS = set("ˈˌ.‿|‖  ")


# Pristine copy of the hand-authored table so `load_table` swaps are
# reversible (tests, interactive use).
_BUILTIN_SEGMENTS: Dict[str, Dict[str, int]] = {
    k: dict(v) for k, v in SEGMENTS.items()
}
_MAX_SEG_LEN = max(len(k) for k in SEGMENTS)

_VALUE_MAP = {"+": 1, "-": -1, "0": 0, "1": 1, "-1": -1, "": 0}


def load_table(path: str, replace: bool = True) -> int:
    """Swap the trait table for an external panphon-format feature table.

    This is the drop-in point for restoring exact parity with
    reference-trained ipa_trait checkpoints (v0/v1/v5/v6): the reference
    embeds text with panphon's ternary vectors
    (the reference's `src/text/converters.py:149-188`) and builds the
    multilingual inventory from panphon's full segment list
    (the reference's `src/voxcommunis/decoder.py:88-89`). panphon is not
    vendorable here, but its data file is: pass panphon's ``ipa_all.csv``
    (or ``ipa_bases.csv``) and every consumer of this module — converters,
    the voxcommunis `FeatureDecoder`/`FeatureTokenizer`, and the datasets
    built on them — follows the loaded values.

    Accepted formats:
      * ``.csv``: header row naming the segment column (``ipa``) and the 24
        trait columns (panphon's names == `TRAITS`); values ``+``/``-``/``0``
        (or ``1``/``-1``/``0``).  Extra columns are ignored; all 24 traits
        must be present.
      * ``.npz``: arrays ``segments`` (unicode) and ``values`` (n, 24) int.

    ``replace=True`` (default) clears the built-in hand-authored table first
    so ALL lookups flow through the file; ``replace=False`` merges, with the
    file taking precedence.  The swap mutates the module-level ``SEGMENTS``
    dict in place, so consumers that imported it by reference see it too —
    but objects built BEFORE the call (e.g. a `FeatureDecoder`) keep their
    snapshot: call `load_table` before constructing tokenizers/decoders.

    Returns the number of segments loaded.  `reset_table()` restores the
    built-in table.
    """
    import csv
    import unicodedata

    global _MAX_SEG_LEN

    loaded: Dict[str, Dict[str, int]] = {}
    if str(path).endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        segs, vals = data["segments"], data["values"]
        if vals.shape[1] != N_TRAITS:
            raise ValueError(
                f"values must have {N_TRAITS} columns, got {vals.shape[1]}"
            )
        for seg, row in zip(segs, vals):
            loaded.setdefault(str(seg), dict(zip(TRAITS, (int(v) for v in row))))
    else:
        with open(path, newline="", encoding="utf-8") as fh:
            reader = csv.DictReader(fh)
            cols = reader.fieldnames or []
            seg_col = next(
                (c for c in cols if c.lower() in ("ipa", "segment")), cols[0]
            )
            missing = [t for t in TRAITS if t not in cols]
            if missing:
                raise ValueError(f"feature table missing trait columns: {missing}")
            for rec in reader:
                seg = rec[seg_col]
                vals = {t: _VALUE_MAP[rec[t].strip()] for t in TRAITS}
                # first occurrence is canonical (panphon order); register the
                # NFD form too so either normalization matches
                loaded.setdefault(seg, vals)
                nfd = unicodedata.normalize("NFD", seg)
                if nfd != seg:
                    loaded.setdefault(nfd, vals)
    if not loaded:
        raise ValueError(f"no segments parsed from {path}")
    if replace:
        SEGMENTS.clear()
    SEGMENTS.update(loaded)
    _MAX_SEG_LEN = max(len(k) for k in SEGMENTS)
    return len(loaded)


def reset_table() -> None:
    """Restore the built-in hand-authored trait table (undo `load_table`)."""
    global _MAX_SEG_LEN
    SEGMENTS.clear()
    SEGMENTS.update({k: dict(v) for k, v in _BUILTIN_SEGMENTS.items()})
    _MAX_SEG_LEN = max(len(k) for k in SEGMENTS)


def segment_features(segment: str) -> Optional[np.ndarray]:
    """Trait vector for one IPA segment (with optional diacritics).

    Returns shape (N_TRAITS,) int8 in {-1, 0, 1}, or None if unknown.
    """
    if segment in SEGMENTS:
        return np.array([SEGMENTS[segment][t] for t in TRAITS], dtype=np.int8)
    # strip modifiers: suffix diacritics from the right, then superscript
    # prenasalization / click accompaniments from the left
    mods: List[Dict[str, int]] = []
    base = segment
    while base and base[-1] in _MODIFIERS:
        mods.append(_MODIFIERS[base[-1]])
        base = base[:-1]
    while base and base[0] in _PREFIX_MODIFIERS:
        mods.append(_PREFIX_MODIFIERS[base[0]])
        base = base[1:]
    if base in SEGMENTS:
        d = dict(SEGMENTS[base])
        for m in mods:
            d.update(m)
        return np.array([d[t] for t in TRAITS], dtype=np.int8)
    return None


def word_features(word: str) -> Optional[np.ndarray]:
    """Parse a possibly multi-segment IPA string into per-segment trait rows.

    Greedy longest-match segmentation (like panphon's `word_array`, which
    returns one row per segment — e.g. "aɪ" -> 2 rows). Returns (n_segments,
    N_TRAITS) int8, or None if any part of the string cannot be parsed.
    """
    rows: List[np.ndarray] = []
    i = 0
    if word not in SEGMENTS and word_nfd(word) != word:
        # NFC input (precomposed codepoints like "ĩ" U+0129): decompose so
        # base+combining-diacritic lookup applies. Table keys are stored in
        # their authored (mostly NFD) form, so only recurse when changed.
        return word_features(word_nfd(word))
    # longest key in the (possibly swapped) table, incl. tie bars/modifiers
    max_len = max(_MAX_SEG_LEN, 5)
    while i < len(word):
        match = None
        for ln in range(min(max_len, len(word) - i), 0, -1):
            feats = segment_features(word[i : i + ln])
            if feats is not None:
                match = feats
                i += ln
                break
        if match is None:
            # stray tie bar between segments not listed as a unit: treat the
            # components independently (panphon parses arbitrary ligatures);
            # stress/syllable/boundary marks are featureless — skip them
            if word[i] == "͡" or word[i] in _SKIP_CHARS:
                i += 1
                continue
            return None
        rows.append(match)
    if not rows:
        return None
    return np.stack(rows, axis=0)


def word_nfd(word: str) -> str:
    import unicodedata

    return unicodedata.normalize("NFD", word)


def validate_segment(segment: str) -> bool:
    return word_features(segment) is not None
