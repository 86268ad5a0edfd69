"""Host-side tokenization into fixed-shape [B, L] ids and True=valid masks.

The HF tokenizer is loaded from local files only (MODEL.TEXT_MODEL.LOCAL_PATH);
without them a deterministic hash tokenizer stands in, which is fine for
synthetic serving, tests and benchmarks but not for reference weights -- the
guard below refuses that pairing unless ALLOW_HASH_TOKENIZER is set.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Tuple

import numpy as np

log = logging.getLogger("stcat_tpu_torch")

# RoBERTa special ids
BOS, PAD, EOS = 0, 1, 2


class HashTokenizer:
    """Whitespace + FNV-1a hash tokenizer with RoBERTa-style specials:
    <s> tokens </s> padded with <pad>; ids land in [special_offset, vocab)."""

    def __init__(self, vocab_size: int = 50265, special_offset: int = 10):
        self.vocab_size = vocab_size
        self.special_offset = special_offset

    def _word_id(self, word: str) -> int:
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return self.special_offset + h % (self.vocab_size - self.special_offset)

    def __call__(self, texts: List[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), max_len), PAD, np.int32)
        valid = np.zeros((len(texts), max_len), bool)
        for i, text in enumerate(texts):
            words = text.lower().split()[: max_len - 2]
            row = [BOS] + [self._word_id(w) for w in words] + [EOS]
            ids[i, : len(row)] = row
            valid[i, : len(row)] = True
        return ids, valid


class HFTokenizer:
    """RobertaTokenizerFast from a local directory, padded to max_len."""

    def __init__(self, path: str):
        from transformers import RobertaTokenizerFast

        self.tok = RobertaTokenizerFast.from_pretrained(path, local_files_only=True)

    def __call__(self, texts: List[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.tok(texts, padding="max_length", truncation=True, max_length=max_len,
                       return_tensors="np")
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(bool)


def weights_are_reference_derived(weight: str) -> bool:
    """True when MODEL.WEIGHT names weights trained against the real
    roberta-base vocabulary: a torch checkpoint, or a checkpoint directory
    whose provenance.json says it was converted from the reference."""
    if not weight:
        return False
    if weight.endswith((".pth", ".pt", ".bin")):
        return True
    base = weight.rstrip("/")
    for d in (base, os.path.dirname(base)):
        marker = os.path.join(d, "provenance.json") if d else ""
        if marker and os.path.isfile(marker):
            try:
                with open(marker) as f:
                    return bool(json.load(f).get("converted_from_reference"))
            except (OSError, ValueError):
                return True  # unreadable marker: assume reference-derived
    return False


def check_tokenizer_for_weights(cfg, tokenizer, weight: str, what: str = "inference") -> None:
    """Refuse reference-derived weights with the hash tokenizer (garbage
    results) unless MODEL.TEXT_MODEL.ALLOW_HASH_TOKENIZER opts in."""
    if not isinstance(tokenizer, HashTokenizer) or not weights_are_reference_derived(weight):
        return
    if cfg.MODEL.TEXT_MODEL.ALLOW_HASH_TOKENIZER:
        log.warning("ALLOW_HASH_TOKENIZER=true: running %s of reference-derived weights "
                    "(%s) with the HASH tokenizer; results will not match the reference.",
                    what, weight)
        return
    raise RuntimeError(
        f"Refusing {what}: MODEL.WEIGHT={weight!r} is reference-derived, but no "
        "roberta-base tokenizer files were found, so the stand-in HASH tokenizer is "
        "active and its ids do not match the weights' vocabulary. Put "
        "vocab.json/merges.txt under MODEL.TEXT_MODEL.LOCAL_PATH, or pass "
        "MODEL.TEXT_MODEL.ALLOW_HASH_TOKENIZER true to override knowingly."
    )


def build_tokenizer(cfg):
    """HF tokenizer from MODEL.TEXT_MODEL.LOCAL_PATH when that directory
    exists, else the hash tokenizer."""
    path = cfg.MODEL.TEXT_MODEL.LOCAL_PATH
    if path and os.path.isdir(path):
        return HFTokenizer(path)
    log.warning("No local tokenizer files (MODEL.TEXT_MODEL.LOCAL_PATH=%r): using the "
                "deterministic HASH tokenizer.", path)
    return HashTokenizer(vocab_size=cfg.MODEL.TEXT_MODEL.VOCAB_SIZE)
