"""Calibration and evaluation data, from local files only.

Port of ``dgq_tpu/utils/datautils.py``: ``synthetic_stream`` (the same numpy
stream as JAX's, token for token), ``get_calib_samples`` (nsamples random
seqlen-token windows of the train split, seeded) and ``get_eval_stream``
(the eval split's token stream, with the reference's split and joining
conventions).  The text datasets (wikitext2, ptb, c4 and the ``_new``
variants) need the ``datasets`` and ``transformers`` packages and a local
copy of the corpus (``data_path``, or the HF cache); where a package is
missing they raise ``ModuleNotFoundError`` naming it, and the entry CLI
skips that eval.  Nothing is downloaded.
"""

from __future__ import annotations

import importlib
import os
from typing import Optional

import numpy as np


def _require(package: str):
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ModuleNotFoundError(
            f"the {package!r} package is needed for text datasets and is not installed; "
            "use the 'synthetic' dataset, or install it with a local copy of the corpus",
            name=package) from e


def _tokenizer(model_path: str):
    return _require("transformers").AutoTokenizer.from_pretrained(model_path, use_fast=True)


def synthetic_stream(vocab_size: int, n_tokens: int, seed: int = 0) -> np.ndarray:
    """Deterministic Zipf-ish token stream for offline runs."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab_size, size=n_tokens, p=probs).astype(np.int32)


def _load_text_dataset(name: str, split: str, data_path: Optional[str]):
    """The text rows of a dataset split, from ``data_path`` or the local HF
    cache."""
    ds = _require("datasets")
    base = {"ptb_new": "ptb", "c4_new": "c4"}.get(name, name)
    if data_path is not None:
        return ds.load_from_disk(os.path.join(data_path, f"{base}-{split}"))
    if base == "wikitext2":
        return ds.load_dataset("wikitext", "wikitext-2-raw-v1", split=split)
    if base == "ptb":
        return ds.load_dataset("ptb_text_only", "penn_treebank", split=split)
    if base == "c4":
        files = {"train": "en/c4-train.00000-of-01024.json.gz",
                 "validation": "en/c4-validation.00000-of-00008.json.gz"}
        return ds.load_dataset("allenai/c4", data_files={split: files[split]}, split=split)
    raise ValueError(name)


def _join_text(rows, name: str) -> str:
    """wikitext2/c4 and ptb join with "\\n\\n", ptb_new with " "."""
    key = "sentence" if name in ("ptb", "ptb_new") else "text"
    if name == "ptb_new":
        return " ".join(r[key] for r in rows)
    return "\n\n".join(r[key] for r in rows)


def _c4_row_windows(rows, tok, n: int, seqlen: int, seed: int) -> np.ndarray:
    """n random seqlen-token windows, one per long-enough random row, in the
    reference's python ``random`` call order."""
    import random as _random

    rng = _random.Random()
    rng.seed(seed)
    out = []
    for _ in range(n):
        while True:
            i = rng.randint(0, len(rows) - 1)
            ids = tok(rows[i]["text"], return_tensors="np").input_ids[0]
            if ids.shape[0] > seqlen:
                break
        i = rng.randint(0, ids.shape[0] - seqlen - 1)
        out.append(ids[i:i + seqlen].astype(np.int32))
    return np.stack(out)


def get_calib_samples(name: str, nsamples: int, *, seed: int = 0, seqlen: int = 2048,
                      model_path: Optional[str] = None, vocab_size: int = 32000,
                      data_path: Optional[str] = None) -> np.ndarray:
    """(nsamples, seqlen) int32 calibration windows."""
    if name == "synthetic":
        stream = synthetic_stream(vocab_size, max(nsamples * seqlen * 2, seqlen + 1), seed)
    elif name in ("c4", "c4_new"):
        rows = _load_text_dataset(name, "train", data_path)
        return _c4_row_windows(rows, _tokenizer(model_path), nsamples, seqlen, seed)
    else:
        rows = _load_text_dataset(name, "train", data_path)
        tok = _tokenizer(model_path)
        stream = np.asarray(tok(_join_text(rows, name), return_tensors="np").input_ids[0],
                            dtype=np.int32)
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(nsamples):
        i = rng.integers(0, len(stream) - seqlen - 1)
        samples.append(stream[i:i + seqlen])
    return np.stack(samples)


def get_eval_stream(name: str, *, seqlen: int = 2048, model_path: Optional[str] = None,
                    vocab_size: int = 32000, n_tokens: int = 1 << 17,
                    data_path: Optional[str] = None, seed: int = 1234) -> np.ndarray:
    """Flat token stream of the eval split: wikitext2 test ("\\n\\n"), ptb
    validation ("\\n\\n"), ptb_new test (" "), c4 256 random windows of
    validation rows (seed 0), c4_new the first 1100 validation rows joined
    and cut to 256 windows."""
    if name == "synthetic":
        return synthetic_stream(vocab_size, n_tokens, seed)
    tok = _tokenizer(model_path)
    if name == "c4":
        rows = _load_text_dataset(name, "validation", data_path)
        return _c4_row_windows(rows, tok, 256, seqlen, seed=0).reshape(-1)
    if name == "c4_new":
        rows = _load_text_dataset(name, "validation", data_path)
        text = " ".join(rows[i]["text"] for i in range(min(1100, len(rows))))
        ids = tok(text, return_tensors="np").input_ids[0]
        return np.asarray(ids[:256 * seqlen], dtype=np.int32)
    split = "validation" if name == "ptb" else "test"
    rows = _load_text_dataset(name, split, data_path)
    return np.asarray(tok(_join_text(rows, name), return_tensors="np").input_ids[0],
                      dtype=np.int32)
