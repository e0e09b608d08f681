"""The port's reliability trainer (stringdecomposer_tpu_torch/models/reliability.py:
train_logreg, save_coefficients, main) on the CPU, against the JAX
package's optax trainer on the same seeded features.

Tolerance: both fit in float32 with the same Adam (betas 0.9 / 0.999, eps
1e-8, lr 0.05, 2,000 steps from zero weights); the gradients' float32
operations differ in order, so the coefficients may differ in their last
bits, and are held to max |coef_port - coef_jax| <= 1e-3 * max(1, |coef|).
classify must agree on every row."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.models import reliability as j_rel
from stringdecomposer_tpu_torch.models import reliability as t_rel

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def _rows(seed: int, n: int = 400) -> list[str]:
    """The labeled set of test_properties.py::test_reliability_trainer_roundtrip:
    identity, second-best identity, '+' where identity + diff > 95."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        idnt = rng.uniform(50, 100)
        diff = rng.uniform(0, 20)
        label = "+" if (idnt + diff) > 95 else "?"
        rows.append(f"{idnt:.2f}\t{idnt - diff:.2f}\t{label}\n")
    return rows


def _features(rows):
    a = np.array([[float(x) for x in r.split("\t")[:2]] for r in rows])
    labels = np.array([1.0 if r.rstrip("\n").split("\t")[2] == "+" else 0.0 for r in rows])
    return np.stack([a[:, 0], a[:, 0] - a[:, 1]], axis=1), labels


def test_reliability_trainer_roundtrip(tmp_path):
    """Port of test_properties.py::test_reliability_trainer_roundtrip: the
    CLI refits coefficients that separate a linearly separable labeled set,
    in the shipped model's file format."""
    data = tmp_path / "train.tsv"
    data.write_text("".join(_rows(0)))
    out = tmp_path / "model.txt"
    assert t_rel.main([str(data), str(out), "--device", "cpu"]) == 0
    coef = t_rel.load_coefficients(str(out))
    assert coef.shape == (3,)
    got = t_rel.classify(np.array([99.0, 60.0]), np.array([80.0, 59.0]), coef)
    assert got[0] and not got[1]
    assert out.read_text().count(" ") == 2 and out.read_text().endswith("\n")


@pytest.mark.parametrize("seed", [0, 1])
def test_train_logreg_matches_jax(seed):
    feats, labels = _features(_rows(seed))
    want = j_rel.train_logreg(feats, labels)
    got = t_rel.train_logreg(feats, labels, device="cpu")
    assert got.dtype == np.float64 and got.shape == (3,)
    assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())
    ours = t_rel.classify(feats[:, 0], feats[:, 0] - feats[:, 1], got)
    theirs = j_rel.classify(feats[:, 0], feats[:, 0] - feats[:, 1], want)
    np.testing.assert_array_equal(ours, theirs)
    assert (ours == (labels > 0.5)).mean() > 0.95


def test_saved_file_and_accuracy_line_match_jax(tmp_path, capsys):
    """main() of both packages on one file: the same usage, the same printed
    accuracy line, and coefficient files of the same format whose values
    agree within the tolerance above."""
    data = tmp_path / "train.tsv"
    data.write_text("".join(_rows(2)) + "\n")  # a blank line is skipped
    assert j_rel.main([str(data), str(tmp_path / "jax.txt")]) == 0
    jax_line = capsys.readouterr().out.replace("jax.txt", "X")
    assert t_rel.main([str(data), str(tmp_path / "port.txt"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.replace("port.txt", "X") == jax_line
    want = j_rel.load_coefficients(str(tmp_path / "jax.txt"))
    got = t_rel.load_coefficients(str(tmp_path / "port.txt"))
    assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())
    assert t_rel.main([str(data)]) == 2  # usage
    assert "Usage" in capsys.readouterr().out
    path = tmp_path / "fmt.txt"
    t_rel.save_coefficients(np.array([-1.5, 0.25, 1 / 3]), str(path))
    j_rel.save_coefficients(np.array([-1.5, 0.25, 1 / 3]), str(tmp_path / "jfmt.txt"))
    assert path.read_text() == (tmp_path / "jfmt.txt").read_text() == \
        "-1.50000000 0.25000000 0.33333333\n"


def test_trainer_defaults_to_the_card(tmp_path, monkeypatch):
    """The trainer's entry point runs on the GPU unless told otherwise, and
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats, labels = _features(_rows(0, 20))
    with pytest.raises(RuntimeError, match="cuda"):
        t_rel.train_logreg(feats, labels)


def test_module_entry_point(tmp_path):
    """python -m stringdecomposer_tpu_torch.models.reliability ... --device cpu."""
    data = tmp_path / "train.tsv"
    data.write_text("".join(_rows(0, 100)))
    res = subprocess.run(
        [sys.executable, "-m", "stringdecomposer_tpu_torch.models.reliability", str(data),
         str(tmp_path / "m.txt"), "--device", "cpu"],
        capture_output=True, text=True, env=ENV, cwd=REPO,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "train accuracy" in res.stdout
    assert t_rel.load_coefficients(str(tmp_path / "m.txt")).shape == (3,)
