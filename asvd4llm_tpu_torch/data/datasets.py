"""Calibration / evaluation data.

Counterpart of asvd4llm_tpu/data/datasets.py for the ``synthetic`` corpus,
which both packages generate from a seed with the same numpy and
``random`` calls, so their token ids are bit-identical. The reference's
HF corpora (wikitext2, c4, ptb, alpaca) need the ``datasets`` package and a
tokenizer; they are still to port (ROADMAP queue 1) and raise here.

Loader contract (ref datautils.py:106-160): a list of
{"input_ids": [1, L] int64, "attention_mask": [1, L]} numpy dicts.
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

_WORDS = None


def _word_bank(n=4096, seed=1234):
    global _WORDS
    if _WORDS is None:
        rng = random.Random(seed)
        alphabet = "abcdefghijklmnopqrstuvwxyz"
        _WORDS = ["".join(rng.choice(alphabet)
                          for _ in range(rng.randint(2, 9)))
                  for _ in range(n)]
    return _WORDS


def synthetic_text_corpus(n_chars: int, seed: int = 0) -> str:
    """Deterministic Zipf-ish pseudo-text for offline operation."""
    words = _word_bank()
    rng = np.random.RandomState(seed)
    out = []
    total = 0
    while total < n_chars:
        sent_len = int(rng.randint(4, 20))
        idx = rng.zipf(1.3, size=sent_len) % len(words)
        sent = " ".join(words[i] for i in idx) + "."
        out.append(sent)
        total += len(sent) + 1
    return " ".join(out)


def synthetic_token_corpus(n_tokens: int, vocab_size: int, seed: int = 0,
                           ) -> np.ndarray:
    """Deterministic token stream: Zipf-distributed unigrams overlaid with
    a repeated motif, so a random model still sees non-uniform channel
    activations."""
    rng = np.random.RandomState(seed)
    toks = rng.zipf(1.5, size=n_tokens).astype(np.int64) % vocab_size
    motif = rng.randint(0, vocab_size, size=16)
    for start in range(0, n_tokens - 16, 256):
        toks[start:start + 16] = motif
    return toks


def _not_ported(name: str):
    return NotImplementedError(
        f"dataset {name!r} needs the HF datasets package and a tokenizer; "
        "only 'synthetic' is ported (ROADMAP queue 1)")


def get_calib_data(name: str, tokenizer, model_id: str, nsamples: int,
                   seqlen: int = 2048, seed: int = 3, use_bos: bool = False,
                   cache_dir: str = "cache", use_cache: bool = True,
                   vocab_size: Optional[int] = None,
                   fixed_alpaca_template: bool = False) -> list[dict]:
    """nsamples random seqlen windows of the synthetic token corpus, cached
    under ``cache_dir`` in the JAX package's file naming."""
    if name != "synthetic":
        raise _not_ported(name)
    assert vocab_size is not None, "synthetic calib needs vocab_size"
    os.makedirs(cache_dir, exist_ok=True)
    cache_file = os.path.join(
        cache_dir,
        f"{name}_{model_id.replace('/', '_')}_{nsamples}_{seqlen}_{seed}"
        f"_bos{use_bos}.npz")
    if use_cache and os.path.exists(cache_file):
        z = np.load(cache_file)
        return [{"input_ids": z[f"ids_{i}"],
                 "attention_mask": np.ones_like(z[f"ids_{i}"])}
                for i in range(int(z["n"]))]

    rng = random.Random(seed)
    corpus = synthetic_token_corpus(max(nsamples * seqlen * 2, 4 * seqlen),
                                    vocab_size, seed=seed)
    samples = []
    for _ in range(nsamples):
        i = rng.randint(0, len(corpus) - seqlen - 1)
        samples.append(corpus[i:i + seqlen][None, :])

    np.savez(cache_file, n=len(samples),
             **{f"ids_{i}": s for i, s in enumerate(samples)})
    return [{"input_ids": s, "attention_mask": np.ones_like(s)}
            for s in samples]


def get_eval_tokens(name: str, tokenizer, cache_dir: str = "cache",
                    use_cache: bool = True, vocab_size: Optional[int] = None,
                    synthetic_len: int = 64_000, seed: int = 0,
                    model_id: str = "") -> np.ndarray:
    """Concatenated eval token ids [1, N] of the synthetic corpus (the cache
    key carries the model id and vocab size, as in the JAX package)."""
    if name != "synthetic":
        raise _not_ported(name)
    assert vocab_size is not None, "synthetic eval needs vocab_size"
    os.makedirs(cache_dir, exist_ok=True)
    tok_tag = model_id.replace("/", "_") if model_id else \
        getattr(tokenizer, "name_or_path", "").replace("/", "_")
    key = f"{tok_tag}_v{vocab_size}_synth{seed}"
    cache_file = os.path.join(cache_dir, f"eval_{name}_{key}_tokens.npy")
    if use_cache and os.path.exists(cache_file):
        return np.load(cache_file)
    toks = synthetic_token_corpus(synthetic_len, vocab_size, seed=seed)[None, :]
    np.save(cache_file, toks)
    return toks
