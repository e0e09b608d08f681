"""Reliability classification of monomer assignments; the port's copy of
the JAX package's models/reliability.py (`load_coefficients` and
`classify`; the refitting trainer stays in the JAX package).

A pretrained 3-coefficient logistic regression on
[1, identity, identity - second_best_identity] flags low-confidence blocks
with '?' (reference: main.py:22-26, 95-104 + models/ont_logreg_model.txt).
The decision is sign(X @ coef) > 0; the coefficient file beside this module
is the reference's, verbatim. Host code: a few flops per block.
"""

from __future__ import annotations

import os

import numpy as np

_MODEL_FILE = os.path.join(os.path.dirname(__file__), "ont_logreg_model.txt")


def load_coefficients(path: str | None = None) -> np.ndarray:
    with open(path or _MODEL_FILE) as f:
        return np.array([float(x) for x in f.readline().split()], dtype=np.float64)


def classify(
    scores: np.ndarray, second_best_scores: np.ndarray, coef: np.ndarray | None = None
) -> np.ndarray:
    """Returns a bool array: True = reliable ('+'), False = '?'.

    Mirrors main.py:95-104: X = [1, idnt, idnt - second], flag '?' unless
    X @ coef > 0. In light mode second_best_scores is -1 everywhere, so the
    difference feature becomes idnt + 1 — same quirk as the reference.
    """
    if coef is None:
        coef = load_coefficients()
    idnt = np.asarray(scores, dtype=np.float64)
    diff = idnt - np.asarray(second_best_scores, dtype=np.float64)
    return (coef[0] + idnt * coef[1] + diff * coef[2]) > 0
