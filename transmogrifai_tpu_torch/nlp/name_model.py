"""Trained character-level person-name model: the port's copy of the JAX
package's ``nlp/name_model.py``.

The reference uses pretrained OpenNLP binaries for sensitive-feature and
name detection (NameEntityRecognizer.scala, HumanNameDetector.scala). This
module replaces the detector's core with a trained classifier that
generalizes from character shape:

  * features: hashed character 2/3-grams over the boundary-marked token
    ("^anna$" → "^a", "an", "nn", "na", "a$", "^an", …) + length bucket;
  * model: logistic regression over an embedded multicultural given-name
    corpus against common-word negatives;
  * the weights ship in the port's own ``resources/name_model.npz`` (a
    copy of the JAX package's), and inference is a small numpy dot.
"""
from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ..utils.text import murmur3_32

DIM = 2048
_RESOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "resources", "name_model.npz",
)


def token_features(token: str, dim: int = DIM) -> np.ndarray:
    """Hashed char-2/3-gram indicator vector for one lowercase token."""
    x = np.zeros(dim, dtype=np.float32)
    t = "^" + token.lower() + "$"
    for n in (2, 3):
        for i in range(len(t) - n + 1):
            x[murmur3_32(t[i:i + n], seed=7) % dim] = 1.0
    # length bucket (names cluster in 3-10 chars)
    x[murmur3_32(f"len{min(len(token), 12)}", seed=7) % dim] = 1.0
    return x


def batch_features(tokens: list[str], dim: int = DIM) -> np.ndarray:
    return np.stack([token_features(t, dim) for t in tokens]) if tokens else \
        np.zeros((0, dim), dtype=np.float32)


class NameModel:
    """Loaded logistic name classifier; ``prob`` maps tokens → P(name)."""

    def __init__(self, weights: np.ndarray, intercept: float):
        self.weights = np.asarray(weights, dtype=np.float32)
        self.intercept = float(intercept)

    @classmethod
    def load(cls, path: str = _RESOURCE) -> "NameModel":
        with np.load(path) as z:
            return cls(z["weights"], float(z["intercept"]))

    def prob(self, tokens: list[str]) -> np.ndarray:
        if not tokens:
            return np.zeros(0, dtype=np.float32)
        margins = batch_features(tokens) @ self.weights + self.intercept
        return 1.0 / (1.0 + np.exp(-margins))


@lru_cache(maxsize=1)
def _default_model() -> NameModel | None:
    try:
        return NameModel.load()
    except Exception:
        return None


# per-process memo: sensitive-feature scans re-score the same tokens
# column after column
@lru_cache(maxsize=65536)
def name_probability(token: str) -> float:
    """P(token is a person given-name) under the shipped model; 0.0 when
    the resource is unavailable (the dictionary path still works)."""
    model = _default_model()
    if model is None or not token or not token.isalpha():
        # non-alphabetic tokens land in untrained feature space where the
        # margin is just bias noise — and person names are alphabetic
        return 0.0
    return float(model.prob([token.lower()])[0])


def is_probable_name(token: str, threshold: float = 0.7) -> bool:
    return name_probability(token) >= threshold
