"""The --ed_thr monomer pre-filter, plain PyTorch twin of
stringdecomposer_tpu/ops/hw_filter.py (which imports jax, so nothing here
imports it).

The reference optionally shrinks the DP's monomer set per chunk: the HW
(infix) edit distance of every monomer against the chunk, then keep the
best plus every monomer within ed_thr, ordered by (distance, input index)
(reference: src/main.cpp:128-149). The subset and its order change the
DP's tie-breaking, so both must match exactly.

This module runs on any device; the kernel in ops/hw_filter_cuda.py
computes hw_distance_batch on the card and is checked against it there.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 28


def hw_distance_batch(
    windows: torch.Tensor,  # [B, W] int8 codes, padded with a never-matching code
    window_lens: torch.Tensor,  # [B] int32
    mono: torch.Tensor,  # [M, L] int8 codes, PAD_CODE-padded
    mono_lens: torch.Tensor,  # [M] int32
) -> torch.Tensor:
    """dist[B, M] int32: HW edit distance of each monomer against each
    window (minimum over end columns j <= window_len, free target prefix):

        D[0][j] = 0,  D[i][0] = i,
        D[i][j] = min(D[i-1][j-1] + sub, D[i-1][j] + 1, D[i][j-1] + 1)

    One column over monomer rows per (window, monomer) pair is carried over
    window positions; the "up" chain folds into a prefix min of cand - i."""
    B, W = windows.shape
    M, L = mono.shape
    dev = windows.device
    i_idx = torch.arange(L + 1, dtype=torch.int32, device=dev)
    # row 0 is the boundary and matches no window char
    mono_col = torch.cat([torch.full((M, 1), -1, dtype=torch.int32, device=dev),
                          mono.to(torch.int32)], dim=1)  # [M, L+1]
    end_row = mono_lens.to(torch.int64).clamp(0, L)[None, :, None].expand(B, M, 1)
    D = i_idx.expand(B, M, L + 1).clone()  # D[i][0] = i
    best = D.gather(2, end_row)[:, :, 0]
    wl = window_lens.to(torch.int64)
    n_steps = min(W, int(wl.max())) if B > 0 else 0
    win = windows.to(torch.int32)
    big = torch.full_like(D[:, :, :1], BIG)
    for j in range(1, n_steps + 1):
        sub = (mono_col[None] != win[:, j - 1, None, None]).to(torch.int32)
        diag = torch.cat([big, D[:, :, :-1]], dim=2) + sub
        cand = torch.minimum(D + 1, diag)
        cand[:, :, 0] = 0  # free target prefix: D[0][j] = 0
        Dn = torch.cummin(cand - i_idx, dim=2).values + i_idx
        active = (j <= wl)[:, None]  # [B, 1]
        best = torch.where(active, torch.minimum(best, Dn.gather(2, end_row)[:, :, 0]), best)
        D = torch.where(active[:, :, None], Dn, D)
    return best.to(torch.int32)


def filter_monomers(dist_row: np.ndarray, ed_thr: int) -> np.ndarray:
    """Per-window monomer selection and order (src/main.cpp:135-149): sort
    by (distance, input index); keep index 0 (the best) plus every later
    monomer with distance <= ed_thr. Returns the kept original indices in
    DP order."""
    order = np.lexsort((np.arange(len(dist_row)), dist_row))
    keep = [order[0]]
    for idx in order[1:]:
        if dist_row[idx] <= ed_thr:
            keep.append(idx)
    return np.asarray(keep, dtype=np.int32)


def filter_monomers_device(
    dist: torch.Tensor,  # [B, M] int32 HW distances
    mono: torch.Tensor,  # [M, L] int8 monomer codes
    mono_lens: torch.Tensor,  # [M] int32
    ed_thr: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """filter_monomers for a batch, on the device of `dist`: two argsorts
    and a row gather. Returns (mono_w [B, M, L], lens_w [B, M] with the
    dropped rows at length 0, perm [B, M] int64: the original index of each
    DP row). The kept count of a window is max(1, #(dist <= ed_thr))."""
    B, M = dist.shape
    idx = torch.arange(M, dtype=torch.int64, device=dist.device)[None, :]
    # ascending (distance, input index); the keys are unique, so the sort
    # needs no stability
    order = torch.argsort(dist.to(torch.int64) * M + idx, dim=1)
    dist_sorted = torch.gather(dist, 1, order)
    kept = (idx == 0) | (dist_sorted <= ed_thr)
    # compact the kept rows to the front, keeping the sorted order
    order2 = torch.argsort(torch.where(kept, 0, M) + idx, dim=1)
    perm = torch.gather(order, 1, order2)
    n_keep = kept.sum(dim=1)
    lens_w = torch.where(idx < n_keep[:, None], mono_lens[perm], 0).to(torch.int32)
    return mono[perm], lens_w, perm
