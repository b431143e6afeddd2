"""Lip-reading evaluation: WER / CER / viseme-level rates.

Counterpart of ``dsml_thesis_tpu/metrics/lipread.py``: transcripts of an
external lip reader (AV-HuBERT) are scored against the MEAD ground-truth
sentences at word, character and viseme level. The phoneme -> viseme table
is the Amazon Polly viseme set of the reference's CSV.

Pure Python over the edit-distance library of ``metrics/native.py`` (one C
call a corpus; the Python dynamic program where the library cannot be
built). Words are phonemized with the optional ``phonemizer`` package; without
it, viseme rates take pre-phonemized input.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

# IPA phone -> Amazon Polly viseme class: the reference's
# data/phonemes2visemes.csv (cols 0 -> 4), consumed by espeak IPA output with
# Separator(phone='-') exactly like utils/lipread_utils.py:7-35.
IPA2VISEME = {
    "b": "p", "d": "t", "d͡ʒ": "S", "dʒ": "S", "ð": "T", "f": "f",
    "ɡ": "k", "h": "k", "j": "i", "k": "k", "l": "t", "ɾ": "t",
    "m": "p", "n": "t", "ŋ": "k", "p": "p", "ɹ": "r", "ɹ̩": "r",
    "s": "s", "ʃ": "S", "t": "t", "t͡ʃ": "S", "tʃ": "S", "θ": "T",
    "v": "f", "w": "u", "z": "s", "ʒ": "S",
    "ə": "@", "ɚ": "@", "æ": "a", "aɪ": "a", "aʊ": "a", "ɑ": "a",
    "ɑː": "a", "ɐ": "a", "eɪ": "e", "ɝ": "E", "ɜː": "E", "ɛ": "E",
    "i": "i", "iː": "i", "ɪ": "i", "iə": "i", "ᵻ": "i",
    "oʊ": "o", "ɔ": "O", "ɔː": "O", "ɔɪ": "O",
    "u": "u", "uː": "u", "ʊ": "u", "ʌ": "E",
    "ɛɹ": "er", "ʊɹ": "er", "ɔːɹ": "Or", "ɑːɹ": "ar", "əl": "@t",
    "oːɹ": "Or", "ɪɹ": "ir", "oː": "O", "o": "O", "e": "E", "a": "a",
    "n̩": "t", "ʔ": "", "aɪə": "a",
}

# ARPABET convenience table for pre-phonemized input (viseme classes match
# the CSV: dental fricatives are their own 'T' class, schwa is '@')
PHONEME2VISEME = {
    "b": "p", "m": "p", "p": "p",
    "d": "t", "n": "t", "t": "t", "l": "t", "el": "t",
    "dh": "T", "th": "T",
    "f": "f", "v": "f",
    "g": "k", "hh": "k", "k": "k", "ng": "k",
    "ch": "S", "jh": "S", "sh": "S", "zh": "S",
    "s": "s", "z": "s",
    "r": "r", "er": "@", "w": "u", "y": "i",
    "aa": "a", "ae": "a", "ah": "E", "ax": "@", "ao": "O",
    "aw": "a", "ay": "a",
    "eh": "E", "ey": "e", "ih": "i", "iy": "i",
    "ow": "o", "oy": "O", "uh": "u", "uw": "u",
    "sil": "sil", "sp": "sil",
}


def _strip_stress(ph: str) -> str:
    return "".join(c for c in ph if not c.isdigit()).lower()


def phonemes_to_visemes(phonemes: Iterable[str]) -> List[str]:
    out = []
    for ph in phonemes:
        v = PHONEME2VISEME.get(_strip_stress(ph))
        if v is not None and v != "sil":
            out.append(v)
    return out


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance (iterative DP, O(len(ref) * len(hyp)))."""
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def error_rate(refs: Sequence[Sequence], hyps: Sequence[Sequence]) -> float:
    """Corpus-level rate: sum(edit distances) / sum(ref lengths); the
    distances from the edit-distance library where it is available, else
    from ``edit_distance``."""
    if len(refs) != len(hyps):  # a bare assert strips under -O and zip
        # would silently truncate while the denominator sums ALL refs
        raise ValueError(f"{len(refs)} refs vs {len(hyps)} hyps")
    from .native import edit_distance_batch

    dists = edit_distance_batch([list(r) for r in refs], [list(h) for h in hyps])
    if dists is not None:
        total_err = int(dists.sum())
    else:
        total_err = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    total_len = sum(len(r) for r in refs)
    return total_err / max(total_len, 1)


def wer(ref_texts: Sequence[str], hyp_texts: Sequence[str]) -> float:
    return error_rate(
        [t.lower().split() for t in ref_texts],
        [t.lower().split() for t in hyp_texts],
    )


def cer(ref_texts: Sequence[str], hyp_texts: Sequence[str]) -> float:
    return error_rate(
        [list(t.lower().replace(" ", "")) for t in ref_texts],
        [list(t.lower().replace(" ", "")) for t in hyp_texts],
    )


_BACKEND = None


def text_to_visemes(text: str) -> str:
    """Reference viseme text (utils/lipread_utils.py:37-55): espeak 'en-us'
    IPA phones with Separator(phone='-', word=' '), each word's visemes
    joined into one token, words space-separated — so word-level WER and
    char-level CER both apply to the result."""
    global _BACKEND
    if _BACKEND is None:
        try:
            from phonemizer.backend import EspeakBackend
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "viseme metrics on raw text need the optional `phonemizer` "
                "package; pass pre-phonemized ARPABET sequences to "
                "viseme_error_rate instead"
            ) from e
        _BACKEND = EspeakBackend("en-us", words_mismatch="ignore",
                                 with_stress=False)
    try:
        from phonemizer.separator import Separator

        sep = Separator(phone="-", word=" ")
    except ImportError:  # stubbed backend in tests
        sep = None
    phonemized = _BACKEND.phonemize([text], separator=sep)[0]
    words = []
    for word in phonemized.split(" "):
        vis = [IPA2VISEME[p.strip()] for p in word.split("-")
               if p and p.strip() in IPA2VISEME]
        if vis:
            words.append("".join(vis))
    return " ".join(words)


def viseme_error_rate(
    ref_phonemes: Sequence[Sequence[str]], hyp_phonemes: Sequence[Sequence[str]]
) -> float:
    return error_rate(
        [phonemes_to_visemes(p) for p in ref_phonemes],
        [phonemes_to_visemes(p) for p in hyp_phonemes],
    )


def _macro_rate(refs_tok: Sequence[Sequence],
                hyps_tok: Sequence[Sequence]) -> float:
    """Mean per-utterance rate; the distances from the edit-distance
    library where it is available (one C call a corpus)."""
    if len(refs_tok) != len(hyps_tok):
        raise ValueError(f"{len(refs_tok)} refs vs {len(hyps_tok)} hyps")
    from .native import edit_distance_batch

    dists = edit_distance_batch([list(r) for r in refs_tok],
                                [list(h) for h in hyps_tok])
    if dists is None:
        dists = [edit_distance(r, h) for r, h in zip(refs_tok, hyps_tok)]
    rates = [d / max(len(r), 1) for d, r in zip(dists, refs_tok)]
    return float(sum(rates) / max(len(rates), 1))


def macro_wer(ref_texts: Sequence[str], hyp_texts: Sequence[str]) -> float:
    """Mean of per-utterance WERs — the reference protocol (run_av_hubert.py
    :92-107 averages jiwer.wer per video via AverageMeter.avg), which differs
    from the corpus-pooled wer() whenever sentence lengths vary."""
    return _macro_rate([t.lower().split() for t in ref_texts],
                       [t.lower().split() for t in hyp_texts])


def macro_cer(ref_texts: Sequence[str], hyp_texts: Sequence[str]) -> float:
    """Mean of per-utterance CERs (jiwer.cer semantics: characters of the
    whitespace-normalized string, single spaces kept)."""
    def chars(t):
        return list(" ".join(t.lower().split()))

    return _macro_rate([chars(t) for t in ref_texts],
                       [chars(t) for t in hyp_texts])
