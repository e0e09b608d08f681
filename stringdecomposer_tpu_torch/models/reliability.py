"""Reliability classification of monomer assignments, ported from the JAX
package's models/reliability.py.

A pretrained 3-coefficient logistic regression on
[1, identity, identity - second_best_identity] flags low-confidence blocks
with '?' (reference: main.py:22-26, 95-104 + models/ont_logreg_model.txt).
The decision is sign(X @ coef) > 0; the coefficient file beside this module
is the reference's, verbatim. Host code: a few flops per block.

Also provides a from-scratch trainer (logistic regression by torch.optim's
Adam, on the card unless told otherwise) so users can refit the model for
new basecallers and chemistries; the reference ships only frozen
coefficients:

    python -m stringdecomposer_tpu_torch.models.reliability data.tsv out.txt [--device cpu]
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


def train_logreg(
    features: np.ndarray,  # [N, 2]: identity, identity-diff
    labels: np.ndarray,  # [N] {0, 1}
    steps: int = 2000,
    lr: float = 0.05,
    seed: int = 0,
    device: str = "cuda",
) -> np.ndarray:
    """Fit new [intercept, w_idnt, w_diff] coefficients: full-batch Adam
    (torch.optim's defaults, betas 0.9 / 0.999 and eps 1e-8, which are
    optax.adam's) on the mean binary cross-entropy of the logits X @ w, in
    float32 from zero weights, as the JAX package's trainer. `seed` is kept
    for that trainer's signature; the start is deterministic."""
    import torch
    import torch.nn.functional as F

    from ..pipeline import resolve_device

    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(features), dtype=torch.float32)
    X = torch.cat([torch.ones((f.shape[0], 1)), f], dim=1).to(dev)
    y = torch.as_tensor(np.asarray(labels), dtype=torch.float32).to(dev)
    w = torch.zeros(3, dtype=torch.float32, device=dev, requires_grad=True)
    opt = torch.optim.Adam([w], lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        F.binary_cross_entropy_with_logits(X @ w, y).backward()
        opt.step()
    return w.detach().cpu().numpy().astype(np.float64)


def save_coefficients(coef: np.ndarray, path: str) -> None:
    with open(path, "w") as f:
        f.write(" ".join(f"{c:.8f}" for c in coef) + "\n")


def main(argv=None) -> int:
    """Refit the reliability model from labeled blocks.

    Usage:
        python -m stringdecomposer_tpu_torch.models.reliability data.tsv out.txt [--device cpu]

    data.tsv rows: identity <TAB> second_best_identity <TAB> label
    (label: '+'/'1' reliable, '?'/'0' unreliable: the final-TSV columns 5,
    7 and 12 of a curated run produce this directly). The fit runs on the
    GPU unless `--device cpu` is given.
    """
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if len(argv) == 4 and argv[2] == "--device":
        device = argv.pop()
        argv.pop()
    if len(argv) != 2:
        print(main.__doc__)
        return 2
    feats, labels = [], []
    with open(argv[0]) as f:
        for ln in f:
            if not ln.strip():
                continue
            idnt, second, label = ln.rstrip("\n").split("\t")[:3]
            idnt, second = float(idnt), float(second)
            feats.append([idnt, idnt - second])
            labels.append(1.0 if label in ("+", "1") else 0.0)
    feats_np, labels_np = np.asarray(feats), np.asarray(labels)
    coef = train_logreg(feats_np, labels_np, device=device)
    save_coefficients(coef, argv[1])
    acc = (classify(feats_np[:, 0], feats_np[:, 0] - feats_np[:, 1], coef)
           == (labels_np > 0.5)).mean()
    print(f"saved {argv[1]}; train accuracy {acc:.3f}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
