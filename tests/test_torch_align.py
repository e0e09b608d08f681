"""The general alignment API of the PyTorch port
(stringdecomposer_tpu_torch.ops.align) on the CPU against the reference
edlib fixtures that tests/test_align.py pins the JAX package to (420 cases
of every mode x task with per-case k, 180 Hirschberg cases, 60 + 36
additionalEqualities cases), and against the JAX package's align_batch on
the same inputs. Every output is an integer, a list or a CIGAR string and
must be equal (tolerance 0)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from stringdecomposer_tpu.ops import align as jax_align
from stringdecomposer_tpu_torch.ops import align as A

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
IUPAC = [("N", "A"), ("N", "C"), ("N", "G"), ("N", "T"),
         ("R", "A"), ("R", "G"), ("Y", "C"), ("Y", "T")]
WIDE = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
WIDE_PAIRS = [(WIDE[i], WIDE[26 + i]) for i in range(26)] + \
             [(chr(ord("0") + i), chr(ord("A") + (i % 5))) for i in range(10)]


def _load(*names):
    return [c for n in names for c in json.loads((FIXTURES / n).read_text())]


@pytest.fixture(scope="module")
def align_cases():
    return _load("align_cases.json", "align_cases_b.json")


def _batch(qs, ts, **kw):
    return A.align_batch(qs, ts, device="cpu", **kw)


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
def test_path_task_fixtures(align_cases, mode):
    cases = [c for c in align_cases if c["mode"] == mode]
    assert len(cases) >= 60
    res = _batch([c["q"] for c in cases], [c["t"] for c in cases], mode=mode, task="path")
    for c, r in zip(cases, res):
        if c["k"] >= 0:
            r = _batch([c["q"]], [c["t"]], mode=mode, task="path", k=c["k"])[0]
        assert r["editDistance"] == c["ed"], (c["q"], c["t"])
        if c["ed"] == -1:
            assert r["endLocations"] == [] and r["cigar"] is None
            continue
        assert r["endLocations"] == c["endLocations"], (mode, c["q"], c["t"])
        assert r["startLocations"] == c["startLocations"], (mode, c["q"], c["t"])
        assert r["cigar"] == c["cigar"], (mode, c["q"], c["t"])


def test_standard_cigar(align_cases):
    for c in [c for c in align_cases if c["ed"] >= 0][::5]:
        r = _batch([c["q"]], [c["t"]], mode=c["mode"], task="path",
                   cigar_format="standard")[0]
        assert r["cigar"] == c["cigar_std"], (c["mode"], c["q"], c["t"])


def test_distance_task_skips_locations(align_cases):
    c = next(c for c in align_cases if c["mode"] == "HW" and c["ed"] > 0)
    r = _batch([c["q"]], [c["t"]], mode="HW", task="distance")[0]
    assert r["editDistance"] == c["ed"]
    assert r["endLocations"] == c["endLocations"]
    assert r["startLocations"] is None and r["cigar"] is None


def test_pip_edlib_result_shape(align_cases):
    c = next(c for c in align_cases if c["mode"] == "NW" and c["ed"] > 0)
    r = A.align(c["q"], c["t"], mode="NW", task="path", device="cpu")
    assert r == {"editDistance": c["ed"], "locations": [(0, len(c["t"]) - 1)],
                 "cigar": c["cigar"]}


@pytest.mark.parametrize("bound", [512, 2048])
def test_hirschberg_fixtures(monkeypatch, bound):
    """The reference's Hirschberg route with its memory bound shrunk: the
    engage formula, the lt/2 split and the split-row scan order decide
    which co-optimal CIGAR comes out."""
    cases = [c for c in _load("hirschberg_cases.json") if c["bound"] == bound]
    assert len(cases) == 90
    monkeypatch.setattr(A, "HB_MEM_BOUND", bound)
    for mode in ("NW", "SHW", "HW"):
        sub = [c for c in cases if c["mode"] == mode]
        res = _batch([c["q"] for c in sub], [c["t"] for c in sub], mode=mode, task="path")
        for c, r in zip(sub, res):
            assert r["editDistance"] == c["ed"], (bound, mode)
            assert r["cigar"] == c["cigar"], (bound, mode, c["q"][:40])


@pytest.mark.parametrize("name,pairs", [("edlib_eq_cases.json", IUPAC),
                                        ("edlib_wide_eq_cases.json", WIDE_PAIRS)])
def test_equalities_fixtures(name, pairs):
    """IUPAC-style pairs (mask mode) and a 62-symbol alphabet (lut mode),
    every mode, path task, per-case k."""
    cases = _load(name)
    assert any(c["ed"] >= 0 for c in cases)
    for c in cases:
        r = _batch([c["q"]], [c["t"]], mode=c["mode"], task="path", k=c["k"],
                   additional_equalities=pairs[: c["npairs"]])[0]
        assert r["editDistance"] == c["ed"], (c["q"], c["t"], c["mode"])
        if c["ed"] < 0:
            continue
        assert r["endLocations"] == c["endLocations"], (c["q"], c["t"], c["mode"])
        if c["startLocations"]:
            assert r["startLocations"] == c["startLocations"], (c["q"], c["t"])
        assert r["cigar"] == c["cigar"], (c["q"], c["t"], c["mode"])


def _random_pairs(seed, n=9):
    """Near-identical, unrelated, empty and skewed pairs."""
    rng = np.random.default_rng(seed)
    alpha = np.array(list("ACGT"))
    qs, ts = ["", "ACGT", "GATTACA"], ["ACGTA", "", "GATTACA"]
    for _ in range(n):
        a = rng.integers(0, 4, int(rng.integers(20, 160)))
        b = a.copy() if rng.random() < 0.6 else rng.integers(0, 4, int(rng.integers(20, 200)))
        for i in sorted(rng.choice(len(b), min(len(b), 6), replace=False).tolist(), reverse=True):
            b[i] = (b[i] + 1 + rng.integers(3)) % 4
        qs.append("".join(alpha[a]))
        ts.append("".join(alpha[np.concatenate([rng.integers(0, 4, 15), b])]))
    return qs, ts


@pytest.mark.parametrize("mode", ["NW", "SHW", "HW"])
@pytest.mark.parametrize("task,k", [("path", -1), ("locations", 12), ("path", 40)])
def test_align_batch_matches_jax(mode, task, k):
    qs, ts = _random_pairs(100 * ("NW", "SHW", "HW").index(mode) + k + 2)
    want = jax_align.align_batch(qs, ts, mode=mode, task=task, k=k)
    assert _batch(qs, ts, mode=mode, task=task, k=k) == want


def test_align_batch_matches_jax_with_equalities():
    qs, ts = _random_pairs(5)
    qs = [q.replace("A", "N", 3) for q in qs]
    for mode in ("NW", "HW"):
        want = jax_align.align_batch(qs, ts, mode=mode, task="path", k=30,
                                     additional_equalities=IUPAC)
        assert _batch(qs, ts, mode=mode, task="path", k=30,
                      additional_equalities=IUPAC) == want


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="mode"):
        _batch(["A"], ["A"], mode="XX")
    with pytest.raises(ValueError, match="task"):
        _batch(["A"], ["A"], task="score")
    with pytest.raises(ValueError, match="targets"):
        _batch(["A", "C"], ["A"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        A.align("ACGT", "ACGA")
