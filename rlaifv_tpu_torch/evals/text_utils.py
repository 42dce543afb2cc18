# A copy of rlaifv_tpu/evals/text_utils.py, function for function and under the same
# names: the port keeps its own copy and imports nothing of the JAX package.
"""Tokenization/lemmatization with offline fallbacks.

The reference relies on nltk punkt + WordNet and spaCy en_core_web
(eval/eval_gpt_obj_halbench.py:12-18,203-204,390-404); none of those data
packs can be downloaded in an air-gapped TPU pod. When nltk data is
present we use it (bit-parity with the reference); otherwise a regex
tokenizer + rule-based English noun lemmatizer covers the COCO object
vocabulary the CHAIR metric actually needs.
"""
from __future__ import annotations

import re
from functools import lru_cache
from typing import List

_IRREGULAR = {
    "people": "person", "men": "man", "women": "woman", "children": "child",
    "teeth": "tooth", "feet": "foot", "geese": "goose", "mice": "mouse",
    "knives": "knife", "leaves": "leaf", "loaves": "loaf", "shelves": "shelf",
    "wolves": "wolf", "scarves": "scarf", "buses": "bus", "glasses": "glass",
    "dishes": "dish", "benches": "bench", "sandwiches": "sandwich",
    "couches": "couch", "watches": "watch", "boxes": "box", "foxes": "fox",
    "skis": "ski", "sheep": "sheep", "series": "series", "scissors": "scissors",
}

_KEEP_S = {
    "as", "is", "this", "his", "its", "was", "has", "us", "bus", "glass",
    "grass", "dress", "less", "chess", "press", "class", "pass", "gas",
    "tennis", "kiss", "boss", "cross", "lens", "jeans", "pants", "shorts",
}


@lru_cache(maxsize=1)
def _nltk_ready() -> bool:
    try:
        import nltk
        from nltk.stem import WordNetLemmatizer

        nltk.word_tokenize("probe sentence")
        WordNetLemmatizer().lemmatize("cats")
        return True
    except Exception:
        return False


def tokenize(text: str) -> List[str]:
    if _nltk_ready():
        import nltk

        return nltk.word_tokenize(text)
    return re.findall(r"[a-zA-Z']+|[0-9]+|[^\sa-zA-Z0-9]", text)


def lemmatize(word: str) -> str:
    if _nltk_ready():
        from nltk.stem import WordNetLemmatizer

        return WordNetLemmatizer().lemmatize(word)
    w = word.lower()
    if w in _IRREGULAR:
        return _IRREGULAR[w]
    if w in _KEEP_S or len(w) < 3 or not w.endswith("s"):
        return w
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"
    if w.endswith(("ches", "shes", "xes", "sses", "zes")):
        return w[:-2]
    if w.endswith("ss"):
        return w
    return w[:-1]


def noun_phrases(words: List[str]) -> List[str]:
    """Greedy noun-run extraction used when spaCy POS tags are unavailable
    (replaces eval_gpt_obj_halbench.py:390-404 postagging): treat every
    non-stopword alpha token as a candidate noun."""
    stop = {
        "a", "an", "the", "of", "on", "in", "at", "with", "and", "or", "is",
        "are", "was", "were", "to", "for", "very", "this", "that", "it",
    }
    out, run = [], []
    for w in words:
        if w.isalpha() and w.lower() not in stop:
            run.append(lemmatize(w))
        else:
            if run:
                out.append(" ".join(run))
            run = []
    if run:
        out.append(" ".join(run))
    return out
