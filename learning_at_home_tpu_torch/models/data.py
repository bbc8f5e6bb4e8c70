"""LM data pipeline: byte-level tokenization over local text, with a
synthetic fallback corpus.

The port's copy of ``learning_at_home_tpu/models/data.py`` (numpy only):
for a seed, its corpus and batches equal the JAX package's bit for bit.

The reference's headline experiment trains on WikiText-103.
The dataset is not in the repository and is not fetched; the pipeline
therefore (a) consumes any local text/token file when given
one — point ``--data`` at a WikiText dump to reproduce the reference
setup — and (b) otherwise generates a deterministic synthetic corpus with
natural-language-like statistics (Zipfian unigrams + Markov bigram
structure) so every experiment runs end-to-end out of the box.

Byte-level vocab (256 + specials) keeps the stack dependency-free; a
subword tokenizer can be slotted in via ``encode_fn``.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

VOCAB_SIZE = 258  # 256 bytes + BOS + EOS
BOS, EOS = 256, 257


def encode_bytes(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-8", errors="replace"), dtype=np.uint8)


def synthetic_corpus(n_tokens: int, seed: int = 0) -> np.ndarray:
    """Zipfian word soup over a fixed lexicon (vectorized, deterministic).

    Word identities follow a Zipf law (like natural text); bytes within a
    word are deterministic, so a language model has real structure to
    learn — loss decreases measurably within a few hundred steps."""
    rng = np.random.RandomState(seed)
    lexicon_size = 1024
    lengths = rng.randint(2, 11, size=lexicon_size)
    lexicon = [
        rng.randint(97, 123, size=n).astype(np.uint8) for n in lengths  # a-z
    ]
    ranks = np.arange(1, lexicon_size + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    avg_word = float(np.mean(lengths)) + 1.0  # +1 for the space
    n_words = int(n_tokens / avg_word) + lexicon_size
    word_ids = rng.choice(lexicon_size, size=n_words, p=probs)
    space = np.array([32], np.uint8)
    stream = np.concatenate(
        [part for wid in word_ids for part in (lexicon[wid], space)]
    )
    return stream[:n_tokens].astype(np.int32)


def load_corpus(
    path: Optional[str] = None,
    n_synthetic_tokens: int = 1 << 20,
    seed: int = 0,
) -> np.ndarray:
    """Token stream from a local file (.npy tokens or raw text) or synthetic."""
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if path.endswith(".npy"):
            return np.load(path).astype(np.int32)
        with open(path, "rb") as f:
            return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
    return synthetic_corpus(n_synthetic_tokens, seed)


class LMBatcher:
    """Contiguous next-token-prediction batches over a token stream."""

    def __init__(
        self,
        tokens: np.ndarray,
        batch_size: int,
        seq_len: int,
        seed: int = 0,
    ):
        if len(tokens) < seq_len + 2:
            raise ValueError("corpus shorter than one sequence")
        self.tokens = tokens
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rng = np.random.RandomState(seed)

    def skip(self, n_batches: int) -> None:
        """Advance the RNG past n_batches draws WITHOUT materializing them —
        resume must continue the uninterrupted run's data order, not replay
        batches already trained on."""
        for _ in range(n_batches):
            self.rng.randint(
                0, len(self.tokens) - self.seq_len - 1, size=self.batch_size
            )

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        starts = self.rng.randint(
            0, len(self.tokens) - self.seq_len - 1, size=self.batch_size
        )
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None, :]
        window = self.tokens[idx]
        return window[:, :-1].astype(np.int32), window[:, 1:].astype(np.int32)
