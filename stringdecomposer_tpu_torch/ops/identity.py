"""Batched NW identity, plain PyTorch twin of stringdecomposer_tpu/ops/identity.py.

For every (query, target) pair: the global edit distance D and the column
count of the co-optimal alignment edlib's traceback returns (preference up,
then left, then diagonal; reference src/edlib.cpp:945-1144); matches =
columns - D. `nw_path_spec` is the NumPy executable spec both packages are
pinned to. `packed_both` is the device-side finishing prologue of
stringdecomposer_tpu/ops/identity_pallas.py::nw_identity_packed_both: block
extraction from a resident read, homopolymer collapse, the (block x monomer)
cross product for the raw and homo variants, and the sort by length with its
inverse. It runs on any device with any pairwise scorer.
"""

from __future__ import annotations

import numpy as np
import torch

from .chain_dp import pair_scan

BIG = 1 << 28
Q_PAD = 7  # query/target pad code (never an ACGTN code)
# query cells (pairs x padded query width) per scorer call of packed_both
PAIR_CELLS = 1 << 25


def nw_path_spec(q: str | np.ndarray, t: str | np.ndarray) -> tuple[int, int, int]:
    """Returns (edit_distance, match_columns, total_columns) of the alignment
    edlib NW task="path" would return. O(|q|*|t|) NumPy reference."""
    qa = np.frombuffer(q.encode(), dtype=np.uint8) if isinstance(q, str) else q
    ta = np.frombuffer(t.encode(), dtype=np.uint8) if isinstance(t, str) else t
    m, n = len(qa), len(ta)
    D = np.zeros((m + 1, n + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        sub = (qa[i - 1] != ta).astype(np.int32)
        for j in range(1, n + 1):
            D[i, j] = min(D[i - 1, j] + 1, D[i, j - 1] + 1, D[i - 1, j - 1] + sub[j - 1])
    Mt = np.zeros((m + 1, n + 1), dtype=np.int32)
    Ln = np.zeros((m + 1, n + 1), dtype=np.int32)
    Ln[0, :] = np.arange(n + 1)
    Ln[:, 0] = np.arange(m + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            if D[i - 1, j] + 1 == D[i, j]:  # up first (src/edlib.cpp:1023)
                Mt[i, j] = Mt[i - 1, j]
                Ln[i, j] = Ln[i - 1, j] + 1
            elif D[i, j - 1] + 1 == D[i, j]:  # then left (src/edlib.cpp:1057)
                Mt[i, j] = Mt[i, j - 1]
                Ln[i, j] = Ln[i, j - 1] + 1
            else:  # diagonal (src/edlib.cpp:1088)
                Mt[i, j] = Mt[i - 1, j - 1] + (1 if qa[i - 1] == ta[j - 1] else 0)
                Ln[i, j] = Ln[i - 1, j - 1] + 1
    return int(D[m, n]), int(Mt[m, n]), int(Ln[m, n])


def aai_from_counts(matches: int, total: int) -> float:
    """identity in percent, with the reference's float op order
    (main.py:56-60: aai /= total; return aai*100)."""
    if total == 0:
        return 0.0
    return (float(matches) / float(total)) * 100.0


def nw_identity_batch(
    q: torch.Tensor,  # [P, Lq] integer codes, padded arbitrarily
    q_lens: torch.Tensor,  # [P] int32
    t: torch.Tensor,  # [P, Lt] codes
    t_lens: torch.Tensor,  # [P] int32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dist[P], matches[P], columns[P]) int32. A loop over target
    positions carries one DP column per pair; the within-column up chain
    folds into a constant-offset prefix min with earliest ties."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    q = q.to(torch.int32)
    t = t.to(torch.int32)
    q_lens = q_lens.to(torch.int32)
    t_lens = t_lens.to(torch.int32)
    i_idx = torch.arange(Lq + 1, dtype=torch.int32, device=dev)
    qcol = torch.cat([torch.full((P, 1), -1, dtype=torch.int32, device=dev), q], dim=1)
    D = i_idx.expand(P, Lq + 1).clone()
    Mt = torch.zeros((P, Lq + 1), dtype=torch.int32, device=dev)
    Ln = D.clone()
    qmask = i_idx == q_lens[:, None]  # one-hot at q_len

    def capture(D, Mt, Ln):
        return [torch.where(qmask, x, 0).sum(dim=1, dtype=torch.int32) for x in (D, Mt, Ln)]

    out = capture(D, Mt, Ln)
    big = torch.full((P, 1), BIG, dtype=torch.int32, device=dev)
    zero = torch.zeros((P, 1), dtype=torch.int32, device=dev)
    for j in range(1, Lt + 1):
        sub = (qcol != t[:, j - 1 : j]).to(torch.int32)  # row 0 unused
        leftD = D + 1
        diagD = torch.cat([big, D[:, :-1]], dim=1) + sub
        take_left = leftD <= diagD
        candD = torch.where(take_left, leftD, diagD)
        candMt = torch.where(take_left, Mt, torch.cat([zero, Mt[:, :-1]], dim=1) + (1 - sub))
        candLn = torch.where(take_left, Ln, torch.cat([zero, Ln[:, :-1]], dim=1)) + 1
        candD[:, 0] = j  # boundary row i = 0
        candMt[:, 0] = 0
        candLn[:, 0] = j
        run, (runMt, runLn) = pair_scan(candD - i_idx, [candMt, candLn - i_idx], torch.lt)
        active = (j <= t_lens)[:, None]  # freeze past each target's length
        D = torch.where(active, run + i_idx, D)
        Mt = torch.where(active, runMt, Mt)
        Ln = torch.where(active, runLn + i_idx, Ln)
        hit = j == t_lens
        out = [torch.where(hit, c, o) for c, o in zip(capture(D, Mt, Ln), out)]
    return tuple(out)


def blocks_from_read(read, starts, lens, Lq):
    """[n, Lq] int32 block substrings gathered from the resident read."""
    lane = torch.arange(Lq, dtype=torch.int64, device=read.device)[None, :]
    idx = (starts.to(torch.int64)[:, None] + lane).clamp(0, read.shape[0] - 1)
    return torch.where(lane < lens[:, None], read[idx].to(torch.int32), Q_PAD)


def homo_collapse(q, lens):
    """Run-collapse each row: keep the first char and every change point,
    then a STABLE argsort on the dropped flag compacts kept chars forward."""
    Lq = q.shape[1]
    lane = torch.arange(Lq, dtype=torch.int64, device=q.device)[None, :]
    keep = ((lane == 0) | (q != torch.roll(q, 1, dims=1))) & (lane < lens[:, None])
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    qh = torch.gather(q, 1, order)
    hlens = keep.sum(dim=1).to(torch.int32)
    return torch.where(lane < hlens[:, None], qh, Q_PAD), hlens


def _pieces(sorted_lens: np.ndarray, M: int) -> list[tuple[int, int]]:
    """Split ascending block lengths into runs [a, b) whose scorer call holds
    at most PAIR_CELLS query cells (pairs x padded query width), so that
    memory follows the blocks' lengths, not one outlier's. A block too long
    for the budget alone gets a run of its own."""
    out, a = [], 0
    for b in range(1, len(sorted_lens) + 1):
        if b > a + 1 and (b - a) * M * max(1, int(sorted_lens[b - 1])) > PAIR_CELLS:
            out.append((a, b - 1))
            a = b - 1
    if len(sorted_lens):
        out.append((a, len(sorted_lens)))
    return out


def packed_both(read,starts, lens, t_raw, tl_raw, t_homo, tl_homo, n_pad, Lq, nw):
    """Finishing prologue + scorer: [2, n_pad * M, 2] int32 of (D, columns)
    per (variant, block, monomer), blocks in the given order (pad rows past
    len(starts) are length 0). `nw` is a pairwise scorer with the contract
    of nw_identity_batch. `Lq` bounds the block lengths; each scorer call
    pads its queries only to the longest block it holds."""
    dev = read.device
    lens_np = np.zeros(n_pad, dtype=np.int32)
    n = len(starts)
    lens_np[:n] = np.asarray(lens)
    if n and int(lens_np.max()) > Lq:
        raise ValueError(f"a block of length {int(lens_np.max())} exceeds Lq={Lq}")
    starts_p = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    starts_p[:n] = torch.as_tensor(np.asarray(starts), dtype=torch.int64).to(dev)
    lens_p = torch.from_numpy(lens_np).to(dev)
    # sort blocks by length so that neighbouring pairs do similar work;
    # results are un-permuted below
    order = torch.argsort(lens_p, stable=True)
    s_lens = lens_p[order]
    s_starts = starts_p[order]
    M = t_raw.shape[0]
    sorted_np = np.sort(lens_np, kind="stable")
    res = []
    for a, b in _pieces(sorted_np, M):
        Lp = max(1, int(sorted_np[b - 1]))
        ql = s_lens[a:b]
        q = blocks_from_read(read, s_starts[a:b], ql, Lp)
        qh, hlens = homo_collapse(q, ql)
        part = []
        for qq, qql, tt, tl in ((q, ql, t_raw, tl_raw), (qh, hlens, t_homo, tl_homo)):
            D, _, cols = nw(
                qq.repeat_interleave(M, dim=0), qql.repeat_interleave(M),
                tt.to(torch.int32).repeat(b - a, 1), tl.to(torch.int32).repeat(b - a),
            )
            part.append(torch.stack([D, cols], dim=1))
        res.append(torch.stack(part).reshape(2, b - a, M, 2))
    inv = torch.argsort(order)
    return torch.cat(res, dim=1)[:, inv].reshape(2, n_pad * M, 2)


def nw_identity_packed_both_plain(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo, n_pad, Lq):
    """Plain version of ops/identity_cuda.nw_identity_packed_both."""
    return packed_both(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo,
                       n_pad, Lq, nw_identity_batch)
