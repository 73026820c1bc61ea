"""Prompt tokenization for weightless runs (port of
``cvd_tpu/io/tokenizer.py::HashTokenizer``). The real CLIP tokenizer comes
with checkpoint import, which is not ported yet."""
from __future__ import annotations

from typing import Sequence

import numpy as np

MAX_LENGTH = 77
BOS, EOS = 49406, 49407


class HashTokenizer:
    """Deterministic stand-in tokenizer (random-weights runs only): BOS,
    one id per whitespace word, EOS padding to 77."""

    model_max_length = MAX_LENGTH

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), MAX_LENGTH), EOS, np.int32)
        for i, t in enumerate(texts):
            ids = [BOS] + [
                (hash(w) % (self.vocab_size - 3)) + 1 for w in t.lower().split()
            ][: MAX_LENGTH - 2] + [EOS]
            out[i, : len(ids)] = ids
        return out
