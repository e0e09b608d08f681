"""The routes of the port's alignment API on the CPU: the K4/K5/K6 routes
forced with ops.banded.DEFAULT_BACKEND = "kernel" (their twins run on CPU
tensors) against the scan route and the reference fixtures, and ports of
tests/test_align.py's Hirschberg, equalities, banded and k-doubling tests.
Outputs are integers, lists and CIGAR strings: tolerance 0."""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

from stringdecomposer_tpu_torch.ops import align as A
from stringdecomposer_tpu_torch.ops import banded

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
ALPHA = np.array(list("ACGT"))
IUPAC = [("N", "A"), ("N", "C"), ("N", "G"), ("N", "T"),
         ("R", "A"), ("R", "G"), ("Y", "C"), ("Y", "T")]
OPS = {"=": A.EDOP_MATCH, "X": A.EDOP_MISMATCH, "I": A.EDOP_INSERT, "D": A.EDOP_DELETE}


def _batch(qs, ts, **kw):
    return A.align_batch(qs, ts, device="cpu", **kw)


def _mutate(rng, codes, n_mut):
    out = codes.copy()
    for i in sorted(rng.choice(len(out), n_mut, replace=False).tolist(), reverse=True):
        out[i] = (out[i] + 1 + rng.integers(3)) % 4
    return out


def _cigar_ops(cigar):
    return [OPS[ch] for n, ch in re.findall(r"(\d+)([=XID])", cigar) for _ in range(int(n))]


def _validate_ops(ops, q, t, expect_dist, same=lambda x, y: x == y):
    """A valid OPTIMAL alignment: consumes q and t exactly, '='/'X' agree
    with the characters, cost equals the exact edit distance."""
    i = j = cost = 0
    for op in ops:
        if op == A.EDOP_INSERT:
            i += 1
            cost += 1
        elif op == A.EDOP_DELETE:
            j += 1
            cost += 1
        else:
            assert same(q[i], t[j]) == (op == A.EDOP_MATCH), (i, j, op)
            cost += int(op == A.EDOP_MISMATCH)
            i += 1
            j += 1
    assert (i, j) == (len(q), len(t))
    assert cost == expect_dist, (cost, expect_dist)


def _ref_dist(q, t):
    qb, ql = A._pad_batch([q])
    tb, tl = A._pad_batch([t])
    return int(A._lastrow(qb, ql, tb, tl, device="cpu")[0, len(t)])


@pytest.fixture
def kernel_route(monkeypatch):
    """Force the K4/K5/K6 routes (their twins, on CPU tensors); K5 takes
    bands from k = 8."""
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", "kernel")
    monkeypatch.setattr(banded, "MYERS_MIN_K", 8)


# ---------------------------------------------------------------------------
# forced routes (ports of tests/test_banded_pallas.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("myers_min_k", [256, 8])
def test_fixtures_on_kernel_routes(monkeypatch, myers_min_k):
    """The 420 fixtures of every mode x path task, per-case k, with the
    K4/K5/K6 routes forced; K5 serves the small bands when its threshold
    drops to 8."""
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", "kernel")
    monkeypatch.setattr(banded, "MYERS_MIN_K", myers_min_k)
    cases = [c for n in ("align_cases.json", "align_cases_b.json")
             for c in json.loads((FIXTURES / n).read_text())]
    for c in cases:
        r = _batch([c["q"]], [c["t"]], mode=c["mode"], task="path", k=c["k"])[0]
        assert r["editDistance"] == c["ed"], (c["mode"], c["q"], c["t"])
        if c["ed"] >= 0:
            assert (r["endLocations"], r["startLocations"], r["cigar"]) == \
                (c["endLocations"], c["startLocations"], c["cigar"]), (c["mode"], c["q"])


def test_nw_dist_router_matches_scan(monkeypatch):
    """_banded_nw_dist's lane extraction on the K4 route equals
    dp_banded_nw_batch (callers pre-filter |ql - tl| > k, mirrored here)."""
    rng = np.random.default_rng(4)
    P, Lq, Lt, k = 5, 120, 130, 16
    q = rng.integers(0, 4, (P, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (P, Lt)).astype(np.int32)
    ql = rng.integers(20, Lq + 1, P).astype(np.int32)
    tl = np.clip(ql + rng.integers(-k, k + 1, P), 0, Lt).astype(np.int32)
    want = A.dp_banded_nw_batch(*A._on("cpu", q, ql, t, tl), k=k).numpy()
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", "kernel")
    assert (A._banded_nw_dist(q, ql, t, tl, k=k, device="cpu") == want).all()


@pytest.mark.parametrize("n,n_mut,myers_min_k", [(3000, 60, 256), (4000, 120, 8)])
def test_path_cigar_identical_on_kernel_routes(monkeypatch, n, n_mut, myers_min_k):
    """Hirschberg path through the K4 (then K5) banded sweeps returns the
    scan route's CIGAR: every split decision reads only values <= the
    segment distance, where the routes agree."""
    rng = np.random.default_rng(5 if n == 3000 else 12)
    a = rng.integers(0, 4, n)
    q, t = "".join(ALPHA[a]), "".join(ALPHA[_mutate(rng, a, n_mut)])
    monkeypatch.setattr(A, "MOVES_CELL_LIMIT", 1 << 12)
    r_scan = A.align(q, t, mode="NW", task="path", device="cpu")
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", "kernel")
    monkeypatch.setattr(banded, "MYERS_MIN_K", myers_min_k)
    assert A.align(q, t, mode="NW", task="path", device="cpu") == r_scan


def test_myers_trusted_distance_exact(monkeypatch):
    """_banded_nw_dist on the K5 route: every result <= k equals the true
    NW distance (the k-doubling loop's trust rule)."""
    rng = np.random.default_rng(13)
    monkeypatch.setattr(banded, "MYERS_MIN_K", 8)
    monkeypatch.setattr(A, "NW_DOUBLING_MIN_LEN", 64)
    for _ in range(6):
        n = int(rng.integers(50, 400))
        a = rng.integers(0, 4, n)
        q, t = "".join(ALPHA[a]), "".join(ALPHA[_mutate(rng, a, int(rng.integers(0, n // 8)))])
        monkeypatch.setattr(banded, "DEFAULT_BACKEND", "kernel")
        got = A.align(q, t, mode="NW", device="cpu")["editDistance"]
        monkeypatch.setattr(banded, "DEFAULT_BACKEND", "scan")
        assert got == A.align(q, t, mode="NW", device="cpu")["editDistance"] == _ref_dist(
            np.frombuffer(q.encode(), np.uint8), np.frombuffer(t.encode(), np.uint8))


def test_shw_transposed_route_matches_scan(monkeypatch):
    """Small-k SHW through the transposed banded-NW final column (K4, then
    K5) equals the scan route: distance and every end location."""
    rng = np.random.default_rng(14)
    qs, ts = [], []
    for _ in range(5):
        n = int(rng.integers(300, 900))
        a = rng.integers(0, 4, n)
        tlen = int(rng.integers(n // 2, 2 * n))
        b = np.concatenate([a, rng.integers(0, 4, max(0, tlen - n))])[:tlen]
        qs.append("".join(ALPHA[a]))
        ts.append("".join(ALPHA[_mutate(rng, b, min(int(rng.integers(0, 30)), len(b)))]))
    want = _batch(qs, ts, mode="SHW", task="locations", k=64)
    for myers_min_k in (256, 8):
        monkeypatch.setattr(banded, "DEFAULT_BACKEND", "kernel")
        monkeypatch.setattr(banded, "MYERS_MIN_K", myers_min_k)
        assert _batch(qs, ts, mode="SHW", task="locations", k=64) == want


def test_semi_global_route_matches_scan(monkeypatch):
    """HW and SHW through K6 equal the scan routes, small-k and k = -1,
    including an empty query (the SHW special case in the caller)."""
    rng = np.random.default_rng(15)
    qs, ts = [], []
    for _ in range(4):
        a = rng.integers(0, 4, int(rng.integers(100, 600)))
        big = np.concatenate([rng.integers(0, 4, 300), a, rng.integers(0, 4, 500)])
        qs.append("".join(ALPHA[a]))
        ts.append("".join(ALPHA[_mutate(rng, big, int(rng.integers(0, 20)))]))
    qs.append("")
    ts.append("ACGTACGT")
    for mode in ("HW", "SHW"):
        for k in (48, -1):
            monkeypatch.setattr(banded, "DEFAULT_BACKEND", "scan")
            want = _batch(qs, ts, mode=mode, task="locations", k=k)
            monkeypatch.setattr(banded, "DEFAULT_BACKEND", "kernel")
            assert _batch(qs, ts, mode=mode, task="locations", k=k) == want, (mode, k)


def test_auto_takes_the_scans_on_cpu_tensors(monkeypatch):
    """"auto" routes CPU tensors to the scans: no wrapper is called."""
    from stringdecomposer_tpu_torch.ops import banded_cuda

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel route was taken on the CPU under auto")

    for name in ("banded_final_column_cuda", "banded_myers_cuda", "semi_ends_cuda"):
        monkeypatch.setattr(banded_cuda, name, refuse)
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", "auto")
    monkeypatch.setattr(banded, "MYERS_MIN_K", 8)
    qs, ts = ["ACGT" * 60, "GATTACA" * 30], ["ACGA" * 61, "GATACA" * 33]
    for mode in ("NW", "SHW", "HW"):
        _batch(qs, ts, mode=mode, task="path", k=40)


# ---------------------------------------------------------------------------
# ports of tests/test_align.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["scan", "kernel"])
def test_hirschberg_valid_and_optimal(monkeypatch, route):
    """A tiny cell limit forces deep recursion on modest pairs; the path
    must be a valid optimal alignment."""
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", route)
    monkeypatch.setattr(banded, "MYERS_MIN_K", 8)
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    for lq, lt in [(150, 150), (300, 80), (80, 300), (257, 256), (1, 500), (500, 1), (199, 201)]:
        q = rng.choice(alpha, lq).astype(np.uint8)
        if rng.random() < 0.5:
            t = q.copy()
            for _ in range(max(1, lt // 10)):
                t[int(rng.integers(len(t)))] = rng.choice(alpha)
            t = t[:lt] if len(t) >= lt else np.concatenate(
                [t, rng.choice(alpha, lt - len(t)).astype(np.uint8)])
        else:
            t = rng.choice(alpha, lt).astype(np.uint8)
        _validate_ops(A._hirschberg_ops(q, t, cell_limit=256, device="cpu"), q, t,
                      _ref_dist(q, t))


def test_big_pair_routes_to_hirschberg(monkeypatch):
    """A pair above MOVES_CELL_LIMIT takes Hirschberg (valid, optimal); a
    small pair in the same batch keeps its canonical CIGAR."""
    monkeypatch.setattr(A, "MOVES_CELL_LIMIT", 64 * 64)
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    big_q = rng.choice(alpha, 300).astype(np.uint8)
    big_t = np.concatenate([big_q[:150], rng.choice(alpha, 160).astype(np.uint8)])
    rs = _batch([big_q, b"ACGT"], [big_t, b"AGGT"], task="path")
    assert rs[1]["cigar"] == "1=1X2="
    _validate_ops(_cigar_ops(rs[0]["cigar"]), big_q, big_t, rs[0]["editDistance"])
    assert rs[0]["editDistance"] == _ref_dist(big_q, big_t)


@pytest.mark.parametrize("syms,eqs,lq,lt,limit", [
    (b"ACGTNRY", IUPAC, 220, 260, 48 * 48),
    (b"ABCDEFGHIJKL", [("K", "A"), ("L", "B")], 150, 160, 32 * 32),
])
def test_equalities_hirschberg_route(monkeypatch, syms, eqs, lq, lt, limit):
    """Equality-aware paths through the memory-bounded route (IUPAC pairs;
    12 symbols whose bitmasks need bits past 8): distance equal to the
    small route's, CIGAR a valid optimal alignment under the relation."""
    monkeypatch.setattr(A, "MOVES_CELL_LIMIT", limit)
    rng = np.random.default_rng(9 if lq == 220 else 13)
    q = bytes(rng.choice(list(syms), lq).tolist())
    t = bytes(rng.choice(list(syms), lt).tolist())
    r = _batch([q], [t], task="path", additional_equalities=eqs)[0]
    assert r["editDistance"] == _batch([q], [t], additional_equalities=eqs)[0]["editDistance"]
    rel = {(a, b) for a, b in eqs} | {(b, a) for a, b in eqs}
    _validate_ops(_cigar_ops(r["cigar"]), q, t, r["editDistance"],
                  same=lambda x, y: x == y or (chr(x), chr(y)) in rel)


def test_banded_nw_matches_full():
    """Banded and full NW agree on the k-threshold contract."""
    rng = np.random.default_rng(31)
    alpha = list(b"ACGT")
    qs, ts = [], []
    for lq, lt in [(300, 300), (300, 295), (280, 310), (64, 64), (33, 31)]:
        q = bytes(rng.choice(alpha, lq).tolist())
        if rng.random() < 0.6:
            t = bytearray(q[:lt].ljust(lt, b"A"))
            for _ in range(4):
                t[int(rng.integers(lt))] = int(rng.choice(alpha))
            t = bytes(t)
        else:
            t = bytes(rng.choice(alpha, lt).tolist())
        qs.append(q)
        ts.append(t)
    want = _batch(qs, ts, mode="NW", task="distance", k=-1)
    for k in [0, 1, 3, 8, 20, 50]:
        got = _batch(qs, ts, mode="NW", task="distance", k=k)
        for p, (g, w) in enumerate(zip(got, want)):
            assert g["editDistance"] == (w["editDistance"] if w["editDistance"] <= k else -1)


def test_banded_nw_with_path_and_equalities():
    r = _batch(["ACGTNCGT"], ["ACGTACGA"], mode="NW", task="path", k=2,
               additional_equalities=[("N", "A")])[0]
    assert (r["editDistance"], r["cigar"]) == (1, "7=1X")
    r2 = _batch(["ACGTACGT" * 20], ["TTTT" * 40], mode="NW", task="path", k=3)[0]
    assert r2["editDistance"] == -1 and r2["cigar"] is None


def test_equalities_32_symbol_alphabet():
    """Exactly 32 symbols: the bitmask's bit 31 must survive."""
    syms = bytes(range(65, 97))
    r = _batch([syms], [syms[::-1]], additional_equalities=[(chr(syms[0]), chr(syms[-1]))])[0]
    assert 0 <= r["editDistance"] <= _batch([syms], [syms[::-1]])[0]["editDistance"]


def test_moves_batch_aggregate_cell_budget(monkeypatch):
    """The batched PATH route bounds the padded per-call move tensor, with
    identical results."""
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs = [rng.choice(alpha, int(n)).astype(np.uint8) for n in rng.integers(20, 60, size=12)]
    ts = [rng.choice(alpha, int(n)).astype(np.uint8) for n in rng.integers(20, 60, size=12)]
    want = _batch(qs, ts, task="path")
    calls = {"n": 0, "max_cells": 0}
    real = A.dp_moves_batch

    def counting(pq, pql, pt, ptl, use_mask=False, eq_flat=None):
        calls["n"] += 1
        calls["max_cells"] = max(calls["max_cells"],
                                 pq.shape[0] * (pq.shape[1] + 1) * (pt.shape[1] + 1))
        return real(pq, pql, pt, ptl, use_mask=use_mask, eq_flat=eq_flat)

    budget = 2 * 80 * 80
    monkeypatch.setattr(A, "MOVES_BATCH_CELL_BUDGET", budget)
    monkeypatch.setattr(A, "dp_moves_batch", counting)
    assert _batch(qs, ts, task="path") == want
    assert calls["n"] >= 3
    assert calls["max_cells"] <= budget + 80 * 80


def test_banded_hirschberg_low_divergence():
    """Low-divergence long pairs take the banded sweeps; the path is valid,
    optimal, and the same with the distance known up front."""
    rng = np.random.default_rng(23)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = rng.choice(alpha, 4096).astype(np.uint8)
    q = t.copy()
    mut = rng.random(4096) < 0.02
    q[mut] = rng.choice(alpha, int(mut.sum()))
    d = _ref_dist(q, t)
    ops = A._hirschberg_ops(q, t, cell_limit=1024, device="cpu")
    _validate_ops(ops, q, t, d)
    assert A._hirschberg_ops(q, t, cell_limit=1024, dist=d, device="cpu") == ops


def test_banded_shw_matches_full():
    """Small-k SHW (dp_banded_shw_rows) equals the full scan on the
    k-threshold contract."""
    cases = [c for n in ("align_cases.json", "align_cases_b.json")
             for c in json.loads((FIXTURES / n).read_text()) if c["mode"] == "SHW"][:40]
    qs, ts = [c["q"] for c in cases], [c["t"] for c in cases]
    want = _batch(qs, ts, mode="SHW", task="locations", k=10**9)
    for k in [0, 1, 3, 10]:
        for g, w in zip(_batch(qs, ts, mode="SHW", task="locations", k=k), want):
            if w["editDistance"] <= k:
                assert g == w
            else:
                assert g["editDistance"] == -1 and g["endLocations"] == []


def test_banded_hw_matches_full():
    """Tall-query small-k HW (the adaptive-row chunk scan) equals the full
    free-prefix scan, the not-found contract included."""
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = rng.choice(alpha, 4000).astype(np.uint8)
    t = rng.choice(alpha, 20000).astype(np.uint8)
    for off in (3000, 12000):
        seg = q.copy()
        mut = rng.random(4000) < 0.01
        seg[mut] = rng.choice(alpha, int(mut.sum()))
        t[off:off + 4000] = seg
    want = _batch([q], [t], mode="HW", task="locations", k=10**9)[0]
    assert 0 < want["editDistance"] <= 80
    for k in (80, 200, want["editDistance"] - 1):
        got = _batch([q], [t], mode="HW", task="locations", k=k)[0]
        if want["editDistance"] <= k:
            assert got == want
        else:
            assert got["editDistance"] == -1 and got["endLocations"] == []


@pytest.mark.parametrize("route", ["scan", "kernel"])
def test_nw_distance_doubling_matches_full(monkeypatch, route):
    """k = -1 NW by banded k-doubling equals the one full sweep, for
    similar, dissimilar and degenerate pairs in one batch."""
    rng = np.random.default_rng(30)
    qs, ts = [], []
    for div in (0.0, 0.01, 0.2, 1.0):
        n = int(rng.integers(600, 1400))
        a = rng.integers(0, 4, n)
        b = _mutate(rng, a, int(n * div)) if div < 1.0 else rng.integers(0, 4, n + 37)
        qs.append("".join(ALPHA[a]))
        ts.append("".join(ALPHA[b]))
    qs.append("")
    ts.append("ACGT")
    want = [r["editDistance"] for r in _batch(qs, ts, mode="NW", task="distance")]
    monkeypatch.setattr(A, "NW_DOUBLING_MIN_LEN", 64)
    monkeypatch.setattr(banded, "DEFAULT_BACKEND", route)
    monkeypatch.setattr(banded, "MYERS_MIN_K", 8)
    assert [r["editDistance"] for r in _batch(qs, ts, mode="NW", task="distance")] == want
