"""NW identity of the finishing stage, plain: for a (query, target) pair,
the global edit distance D and the columns of the co-optimal alignment
that edlib's traceback returns, which prefers up, then left, then the
diagonal (reference src/edlib.cpp:945-1144); matches = columns - D and
identity = (matches / columns) * 100 (main.py:56-60).

`nw_path_spec` is a copy of stringdecomposer_tpu_torch/ops/identity.py's
spec at commit 5ef96e3, one pair at a time in loops; `nw_counts` computes
the same for many pairs at once, one anti-diagonal of the DP a step.
"""

from __future__ import annotations

import numpy as np
import torch


def nw_path_spec(q: np.ndarray, t: np.ndarray) -> tuple[int, int, int]:
    """(edit distance, match columns, columns) of one pair, in loops."""
    m, n = len(q), len(t)
    D = np.zeros((m + 1, n + 1), dtype=np.int64)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1,
                          D[i - 1, j - 1] + (0 if q[i - 1] == t[j - 1] else 1))
    Mt = np.zeros((m + 1, n + 1), dtype=np.int64)
    Ln = np.zeros((m + 1, n + 1), dtype=np.int64)
    Ln[0, :] = np.arange(n + 1)
    Ln[:, 0] = np.arange(m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if D[i - 1, j] + 1 == D[i, j]:  # up first (src/edlib.cpp:1023)
                Mt[i, j], Ln[i, j] = Mt[i - 1, j], Ln[i - 1, j] + 1
            elif D[i, j - 1] + 1 == D[i, j]:  # then left (src/edlib.cpp:1057)
                Mt[i, j], Ln[i, j] = Mt[i, j - 1], Ln[i, j - 1] + 1
            else:  # diagonal (src/edlib.cpp:1088)
                Mt[i, j] = Mt[i - 1, j - 1] + (1 if q[i - 1] == t[j - 1] else 0)
                Ln[i, j] = Ln[i - 1, j - 1] + 1
    return int(D[m, n]), int(Mt[m, n]), int(Ln[m, n])


def nw_counts(queries: list[np.ndarray], targets: list[np.ndarray], device,
              prefer: str = "up") -> tuple[np.ndarray, np.ndarray]:
    """(matches, columns) int64 of every pair (queries[p], targets[p]),
    as nw_path_spec gives them. Cell (i, j) sits at index i of
    anti-diagonal i + j: up and left are on the diagonal before, the
    diagonal move two before; cells past a pair's lengths are never read by
    its own last cell. `prefer="diag"` takes the diagonal move first, then
    up, then left: another co-optimal path, used as the benchmark's
    control."""
    P = len(queries)
    if P == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ql = np.array([len(x) for x in queries], dtype=np.int64)
    tl = np.array([len(x) for x in targets], dtype=np.int64)
    m, n = int(ql.max()), int(tl.max())
    Q = np.full((P, m + 1), -1, dtype=np.int64)  # column i holds q[i - 1]
    T = np.full((P, n + 1), -2, dtype=np.int64)  # column j holds t[j - 1]
    for p in range(P):
        Q[p, 1 : ql[p] + 1] = queries[p]
        T[p, 1 : tl[p] + 1] = targets[p]
    Q = torch.from_numpy(Q).to(device)
    T = torch.from_numpy(T).to(device)
    ql_t = torch.from_numpy(ql).to(device)
    want = torch.from_numpy(ql + tl).to(device)
    i = torch.arange(m + 1, device=device)
    big = torch.full((P, 1), 1 << 40, dtype=torch.int64, device=device)
    zero = torch.zeros((P, 1), dtype=torch.int64, device=device)

    def shift(x, fill):  # x[:, i - 1] at index i
        return torch.cat([fill, x[:, :-1]], dim=1)

    # diagonal d = 0: cell (0, 0); diagonal -1: nothing
    D1 = torch.where(i == 0, 0, 1 << 40).expand(P, m + 1).clone()
    M1 = torch.zeros((P, m + 1), dtype=torch.int64, device=device)
    L1 = torch.zeros_like(M1)
    D2, M2, L2 = torch.full_like(D1, 1 << 40), M1.clone(), L1.clone()
    out_m = torch.zeros(P, dtype=torch.int64, device=device)
    out_l = torch.zeros(P, dtype=torch.int64, device=device)
    at = ql_t.clamp(max=m)[:, None]
    for d in range(1, m + n + 1):
        j = d - i  # [m + 1]
        tj = T[:, j.clamp(0, n)]
        sub = (Q != tj).to(torch.int64)
        up_D, up_M, up_L = shift(D1, big), shift(M1, zero), shift(L1, zero)
        dg_D, dg_M, dg_L = shift(D2, big), shift(M2, zero), shift(L2, zero)
        D = torch.minimum(torch.minimum(up_D, D1) + 1, dg_D + sub)
        take_up = up_D + 1 == D
        take_left = ~take_up & (D1 + 1 == D)
        if prefer == "diag":
            take_dg = dg_D + sub == D
            take_up = ~take_dg & take_up
            take_left = ~take_dg & ~take_up & (D1 + 1 == D)
        Mt = torch.where(take_up, up_M, torch.where(take_left, M1, dg_M + 1 - sub))
        Ln = torch.where(take_up, up_L, torch.where(take_left, L1, dg_L)) + 1
        # boundaries: row 0 (i = 0) and column 0 (j = 0)
        D = torch.where(i == 0, j, torch.where(j == 0, i, D))
        Mt = torch.where((i == 0) | (j == 0), 0, Mt)
        Ln = torch.where(i == 0, j, torch.where(j == 0, i, Ln))
        D = torch.where((j < 0) | (j > n), 1 << 40, D)
        hit = want == d
        out_m = torch.where(hit, Mt.gather(1, at)[:, 0], out_m)
        out_l = torch.where(hit, Ln.gather(1, at)[:, 0], out_l)
        D2, M2, L2, D1, M1, L1 = D1, M1, L1, D, Mt, Ln
    return out_m.cpu().numpy(), out_l.cpu().numpy()


def identity(matches: np.ndarray, columns: np.ndarray) -> np.ndarray:
    """(matches / columns) * 100 in float64, 0 where columns is 0."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(columns == 0, 0.0, (matches.astype(np.float64) / columns) * 100.0)
