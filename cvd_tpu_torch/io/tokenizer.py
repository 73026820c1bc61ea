"""Prompt tokenization (port of ``cvd_tpu/io/tokenizer.py``). Uses the SD
folder's CLIP tokenizer (transformers, local files only — matching the
reference's CLIPTokenizer.from_pretrained, inference_epi.py:77); the
deterministic hash tokenizer is for weightless runs."""
from __future__ import annotations

import os
import zlib
from typing import Optional, Sequence

import numpy as np

MAX_LENGTH = 77
BOS, EOS = 49406, 49407


class HashTokenizer:
    """Deterministic stand-in tokenizer (random-weights runs only): BOS,
    one id per whitespace word, EOS padding to 77. A word's id is its CRC-32,
    the same in every process (Python's ``hash`` of a str is salted per
    process, and the ranks of a sharded run must encode the same prompt)."""

    model_max_length = MAX_LENGTH

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), MAX_LENGTH), EOS, np.int32)
        for i, t in enumerate(texts):
            ids = [BOS] + [
                (zlib.crc32(w.encode()) % (self.vocab_size - 3)) + 1 for w in t.lower().split()
            ][: MAX_LENGTH - 2] + [EOS]
            out[i, : len(ids)] = ids
        return out


class CLIPTokenizerWrapper:
    def __init__(self, path: str, subfolder: str = "tokenizer"):
        from transformers import CLIPTokenizer

        self.tok = CLIPTokenizer.from_pretrained(
            os.path.join(path, subfolder), local_files_only=True
        )
        self.model_max_length = self.tok.model_max_length

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        return np.asarray(
            self.tok(
                list(texts),
                padding="max_length",
                max_length=self.tok.model_max_length,
                truncation=True,
                return_tensors="np",
            ).input_ids,
            np.int32,
        )


def get_tokenizer(sd_folder: Optional[str]) -> object:
    """Real-weights runs get the real tokenizer or an error — never a silent
    hash fallback. The reference loads the tokenizer unconditionally from the
    SD folder (inference_epi.py:77); a missing ``tokenizer/`` there means the
    path is wrong, and encoding prompts with the hash stand-in would produce
    garbage with no symptom. The hash tokenizer is reserved for weightless
    runs (``sd_folder is None``, i.e. --random-weights)."""
    if sd_folder is None:
        return HashTokenizer()
    tok_dir = os.path.join(sd_folder, "tokenizer")
    if not os.path.isdir(tok_dir):
        raise FileNotFoundError(
            f"no CLIP tokenizer at {tok_dir!r}: ori_model_path must point at "
            "a diffusers SD folder containing tokenizer/ (use random weights "
            "mode for weightless runs)"
        )
    return CLIPTokenizerWrapper(sd_folder)
