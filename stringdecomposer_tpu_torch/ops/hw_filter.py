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
`hw_distance_myers` repeats that kernel's bit-parallel arithmetic (its
routes' word layouts, segments and warm-up) in plain PyTorch; only the tests
and chip_smoke call it.
"""

from __future__ import annotations

import numpy as np
import torch

from .banded import M32, _add_carry, _shift_up, _up1, _warp_add, pack_bits

BIG = 1 << 28
# K3's routes (csrc/hw_filter.cu) by the monomers' padded length L: the
# thread route holds R = ceil(L / 32) <= 16 words a thread, the warp route
# ceil(L / 32) <= 512 words over a warp's lanes (16 a lane), the wide route
# any L, in stages of WIDE_R words a thread, up to WIDE_MAX_STAGES a band
THREAD_MAX_L = 32 * 16
WARP_MAX_L = 32 * 32 * 16
ROUTES = ("thread", "warp", "wide")
WIDE_R = 8
WIDE_MAX_STAGES = 512
# _row_codes' marks of rows a monomer does not hold and of wildcard rows:
# values that no int8 code equals
NO_ROW, WILD_ROW = -256, -257


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


def hw_route(L: int, route: str = "auto") -> str:
    """The K3 route for monomers padded to L: "auto" picks the thread route
    up to THREAD_MAX_L, the warp route up to WARP_MAX_L, else the wide one;
    a forced route must hold L."""
    if route != "auto" and route not in ROUTES:
        raise ValueError(f"route must be 'auto' or one of {ROUTES}, got {route!r}")
    if route == "auto":
        return "thread" if L <= THREAD_MAX_L else "warp" if L <= WARP_MAX_L else "wide"
    if (route == "thread" and L > THREAD_MAX_L) or (route == "warp" and L > WARP_MAX_L):
        raise ValueError(f"the {route} route takes monomers up to "
                         f"{THREAD_MAX_L if route == 'thread' else WARP_MAX_L} bp, got L = {L}")
    return route


def wide_shape(L: int) -> tuple[int, int]:
    """(stages a band, bands) of K3's wide route (csrc/hw_filter.cu
    hw_wide_kernel) at monomers padded to L: ceil(L / 32) words in stages of
    WIDE_R, a whole number of warps, at most WIDE_MAX_STAGES a band."""
    nw = max(1, -(-L // 32))
    stages = min(32 * -(-nw // (32 * WIDE_R)), WIDE_MAX_STAGES)
    return stages, -(-nw // (stages * WIDE_R))


def segments(W: int, seg_cols: int) -> tuple[int, int]:
    """(segments a pair, columns a segment S) for windows W columns wide:
    seg_cols = S (a multiple of 16) cuts them, 0 gives one segment."""
    if seg_cols < 0 or seg_cols % 16:
        raise ValueError(f"seg_cols must be 0 or a positive multiple of 16, got {seg_cols}")
    if seg_cols:
        return max(1, -(-W // seg_cols)), seg_cols
    return 1, max(16, -(-W // 16) * 16)


def _row_codes(mono, mono_lens, rows: int, right: bool) -> torch.Tensor:
    """[M, rows] int64: the monomer's codes over `rows` rows of its column,
    from row 1 up (`right` False) or right-aligned so that its last row is
    the top one (True); NO_ROW on rows it does not hold, WILD_ROW on the
    wildcard rows below a right-aligned monomer."""
    M, L = mono.shape
    dev = mono.device
    ml = mono_lens.to(device=dev, dtype=torch.int64).clamp(0, L)[:, None]
    idx = torch.arange(rows, device=dev)[None, :] - ((rows - ml) if right else 0)
    codes = torch.full((M, rows), NO_ROW, dtype=torch.int64, device=dev)
    if L:
        got = mono.to(torch.int64).gather(1, idx.clamp(0, L - 1).expand(M, -1))
        codes = torch.where((idx >= 0) & (idx < ml), got, codes)
    return torch.where(idx < 0, WILD_ROW, codes) if right else codes


def hw_distance_myers(windows, window_lens, mono, mono_lens, route: str = "auto",
                      seg_cols: int = 0) -> torch.Tensor:
    """K3 as its routes compute it, dist[B, M] int32 (equal to
    hw_distance_batch): Myers' bit-vector column over 32-row words with HW's
    free start (row 0's horizontal delta 0). Codes 0-4 take their Peq words
    from planes built once; a window code outside 0-4 takes its words from
    the monomer's codes, as the kernels' slow path does.
      thread (L <= 512): R = ceil(L / 32) words, the monomer right-aligned
        under wildcard rows that match every code, the score at bit 31 of
        word R - 1;
      warp (L <= 16,384): 32 lanes of ceil(ceil(L / 32) / 32) words, the
        monomer from row 1, the score at bit mono_len - 1, the carries of
        lane_carries and the seams across lanes;
      wide: the thread route's layout at bands x stages x WIDE_R words
        (wide_shape; the stages' split of the words changes no value), one
        segment.
    seg_cols = S > 0 cuts each window into segments of S columns (thread and
    warp routes); segment s starts fresh at max(0, s S - 2 mono_len)
    (thread route: rounded down to 16) and the pair's result is the minimum
    over its segments of every column each ran (csrc/hw_filter.cu says why
    that is exact)."""
    B, W = windows.shape
    M, L = mono.shape
    dev = windows.device
    route = hw_route(L, route)
    if route == "wide" and seg_cols:
        raise ValueError("the wide route runs one segment a pair")
    nseg, S = segments(W, seg_cols)
    nw = max(1, -(-L // 32))
    if route == "warp":
        R = -(-nw // 32)
        codes = _row_codes(mono, mono_lens, 32 * 32 * R, right=False)
    else:
        if route == "wide":
            stages, bands = wide_shape(L)
            nw = bands * stages * WIDE_R
        codes = _row_codes(mono, mono_lens, 32 * nw, right=True)
    wild = codes == WILD_ROW
    planes = torch.stack([pack_bits((codes == c) | wild) for c in range(5)], dim=1)  # [M, 5, words]
    words = planes.shape[2]
    # thread g = (m, b, s), monomer-major
    g = torch.arange(M * B * nseg, device=dev)
    m_g, b_g, s_g = g // (B * nseg), g // nseg % B, g % nseg
    ml = mono_lens.to(device=dev, dtype=torch.int64).clamp(0, L)[m_g]
    wl = window_lens.to(device=dev, dtype=torch.int64).clamp(0, W)[b_g]
    e_s = s_g * S
    c_end = torch.minimum(wl, e_s + S)
    c0 = (e_s - 2 * ml).clamp(min=0)
    if route == "thread":
        c0 = c0 // 16 * 16
    bits = torch.arange(words, device=dev)[None, :] * 32
    if route == "warp":
        vp = torch.full((len(g), words), M32, dtype=torch.int64, device=dev)
        hot_w = torch.where(ml > 0, (ml - 1) // 32, 0)
        hot_b = (ml - 1) & 31
    else:  # D(i, c0) = i, the wildcard rows below k = 32 words - mono_len at 0
        k = 32 * words - ml
        low = (k[:, None] - bits).clamp(0, 32)
        vp = torch.where(low >= 32, 0, M32 ^ ((torch.ones_like(low) << low.clamp(max=31)) - 1))
    vn = torch.zeros_like(vp)
    score = ml.clone()
    best = ml.clone()
    win = windows.to(device=dev, dtype=torch.int64)
    steps = (c_end - c0).clamp(min=0)
    for i in range(int(steps.max()) if len(g) else 0):
        c = c0 + i
        act = i < steps
        tc = win[b_g, c.clamp(max=max(W - 1, 0))]
        eq = planes[m_g, tc.clamp(0, 4)]
        odd = (act & ((tc < 0) | (tc > 4))).nonzero()[:, 0]
        if len(odd):
            eq[odd] = pack_bits((codes[m_g[odd]] == tc[odd, None]) | wild[m_g[odd]])
        x = eq | vn
        if route == "warp":
            sum_ = _warp_add(x.view(-1, 32, R), vp.view(-1, 32, R)).view(-1, words)
        else:
            sum_ = _add_carry(x & vp, vp)
        d0 = (sum_ ^ vp) | x
        hp = vn | ((d0 | vp) ^ M32)
        hn = d0 & vp
        if route == "warp":
            hph, hnh = hp.gather(1, hot_w[:, None])[:, 0], hn.gather(1, hot_w[:, None])[:, 0]
            delta = torch.where(ml > 0, ((hph >> hot_b) & 1) - ((hnh >> hot_b) & 1), 0)
            hpsh = _shift_up(hp.view(-1, 32, R), 0).view(-1, words)
            hnsh = _shift_up(hn.view(-1, 32, R), 0).view(-1, words)
        else:
            delta = (hp[:, -1] >> 31) - (hn[:, -1] >> 31)
            hpsh, hnsh = _up1(hp, 0), _up1(hn, 0)
        a = act[:, None]
        vp = torch.where(a, (hnsh | ((d0 | hpsh) ^ M32)) & M32, vp)
        vn = torch.where(a, d0 & hpsh, vn)
        score = torch.where(act, score + delta, score)
        best = torch.where(act, torch.minimum(best, score), best)
    return best.view(M, B, nseg).amin(dim=2).t().contiguous().to(torch.int32)
