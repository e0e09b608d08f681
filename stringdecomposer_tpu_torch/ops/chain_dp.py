"""Chain DP, plain PyTorch twin of stringdecomposer_tpu/ops/chain_dp.py.

Same contract and outputs as the JAX `chain_dp_forward` and `block_walk`:
one [M, L] score column per window carried over read positions, the
deletion chain folded into a constant-offset prefix max, and a block-start
pointer propagated per cell with the reference traceback's priority (ins,
unguarded at k == 0; diag; enter) so that no backward pass is needed. The
block walk then turns the per-position end cells into block records.

This module runs on any device; the kernels in ops/chain_dp_cuda.py compute
the same thing on the card and are checked against it there.
"""

from __future__ import annotations

import numpy as np
import torch

INF = -1_000_000  # src/main.cpp:156
NEG = -(1 << 30)
READ_PAD = 6  # never equals any monomer code (monomer pad is 5)


def pair_scan(t: torch.Tensor, payloads: list[torch.Tensor], later_wins) -> tuple:
    """Inclusive scan along the last axis of (t, *payloads) where a later
    element replaces the running one only if `later_wins(t_later, t_run)`
    (a strict comparison, so ties keep the EARLIEST payload). Log-step
    (Hillis-Steele) form: torch.cummax/cummin keep the LAST index on ties,
    so their indices cannot carry the payload."""
    n = t.shape[-1]
    s = 1
    while s < n:
        ta, tb = t[..., :-s], t[..., s:]
        take_b = later_wins(tb, ta)
        t = torch.cat([t[..., :s], torch.where(take_b, tb, ta)], dim=-1)
        payloads = [
            torch.cat([p[..., :s], torch.where(take_b, p[..., s:], p[..., :-s])], dim=-1)
            for p in payloads
        ]
        s *= 2
    return t, payloads


def init_column(windows, mono_b, lens_b, dele, mismatch, match):
    """Column i = 0 (src/main.cpp:171-182): [B, M, L] int32 scores. Its
    start pointers are all 0: the traceback closes the running block with
    start 0 when it reaches read position 0."""
    L = mono_b.shape[-1]
    k_del = torch.arange(L, dtype=torch.int32, device=windows.device) * dele
    read0 = windows[:, 0].to(torch.int32)[:, None, None]
    mm0 = torch.where(mono_b.to(torch.int32) == read0, match, mismatch).to(torch.int32)
    cand0 = (k_del - dele) + mm0
    cand0[:, :, 0] = mm0[:, :, 0]
    return torch.cummax(cand0 - k_del, dim=2).values + k_del


def broadcast_monomers(mono, mono_lens, B):
    """Shared [M, L] or per-window [B, M, L] monomers -> [B, M, L], [B, M]."""
    if mono.dim() == 2:
        return mono.expand(B, *mono.shape), mono_lens.expand(B, *mono_lens.shape)
    return mono, mono_lens


def chain_dp_forward(
    windows: torch.Tensor,  # [B, W] int8, padded with READ_PAD
    window_lens: torch.Tensor,  # [B] int32 true lengths
    mono: torch.Tensor,  # [M, L] or [B, M, L] int8, padded with PAD_CODE(5)
    mono_lens: torch.Tensor,  # [M] or [B, M] int32
    ins: int = -1,
    dele: int = -1,
    mismatch: int = -1,
    match: int = 1,
    max_blocks: int = 0,  # 0 -> W
    return_debug: bool = False,  # additionally return (chain, end, spend)
):
    """Chain DP + block walk over a batch of read windows. Returns
    (blocks[B, max_blocks, 4], counts[B]) int32; each record is
    (monomer_idx, start, end, identity) in window coordinates, last block
    first."""
    B, W = windows.shape
    if max_blocks == 0:
        max_blocks = W
    dev = windows.device
    mono_b, lens_b = broadcast_monomers(mono, mono_lens, B)
    L = mono_b.shape[2]
    k_idx = torch.arange(L, dtype=torch.int32, device=dev)
    k_del = k_idx * dele
    end_mask = k_idx == (lens_b.to(torch.int32)[:, :, None] - 1)  # [B, M, L]
    mono_i32 = mono_b.to(torch.int32)
    win_i32 = windows.to(torch.int32)
    neg = torch.tensor(NEG, dtype=torch.int32, device=dev)

    def masked_ends(dp):
        return torch.where(end_mask, dp, neg).amax(dim=2)

    def gather_ends(x):  # one end cell per row, so a sum picks it
        return torch.where(end_mask, x, 0).sum(dim=2, dtype=torch.int32)

    dp = init_column(windows, mono_b, lens_b, dele, mismatch, match)
    sp = torch.zeros_like(dp)
    chains = [torch.full((B,), INF, dtype=torch.int32, device=dev)]
    ends = [masked_ends(dp)]
    spends = [gather_ends(sp)]
    neg_col = torch.full_like(dp[:, :, :1], NEG)
    zero_col = torch.zeros_like(sp[:, :, :1])
    for i in range(1, W):
        mm = torch.where(mono_i32 == win_i32[:, i, None, None], match, mismatch).to(torch.int32)
        chain_i = ends[-1].amax(dim=1)  # [B]
        prev_shift = torch.cat([neg_col, dp[:, :, :-1]], dim=2)
        sp_shift = torch.cat([zero_col, sp[:, :, :-1]], dim=2)
        enter = chain_i[:, None, None] + mm + k_del
        diag = prev_shift + mm
        diag[:, :, 0] = NEG
        insr = dp + ins
        insr_c = insr.clone()
        insr_c[:, :, 0] = NEG
        t = torch.maximum(enter, torch.maximum(diag, insr_c)) - k_del
        dp_new = torch.cummax(t, dim=2).values + k_del
        # payload as if this cell explains the score: ins (unguarded at
        # k == 0, like src/main.cpp:245), then diag, then enter
        candstart = torch.where(
            dp_new == insr, sp, torch.where(dp_new == diag, sp_shift, i)
        ).to(torch.int32)
        _, (sp,) = pair_scan(t, [candstart], torch.gt)
        dp = dp_new
        chains.append(chain_i)
        ends.append(masked_ends(dp))
        spends.append(gather_ends(sp))
    end = torch.stack(ends, dim=1)  # [B, W, M]
    spend = torch.stack(spends, dim=1)
    blocks, counts = block_walk(end, spend, window_lens, max_blocks)
    if return_debug:
        return blocks, counts, (torch.stack(chains, dim=1), end, spend)
    return blocks, counts


def block_walk(
    end: torch.Tensor,  # [B, W, M] int32 (rows without cells end below all real)
    spend: torch.Tensor,  # [B, W, M] int32
    window_lens: torch.Tensor,  # [B] int32
    max_blocks: int,
):
    """Block walk (replaces the backward traceback, src/main.cpp:209-269),
    vectorised over windows: one step per block. The chain score at a block
    start s is max_j end[s-1, j]; the next block is the leftmost argmax of
    that column (torch.argmax returns the first maximum). Counts keep
    growing past max_blocks without writing past the array."""
    B, W, M = end.shape
    dev = end.device
    rows = torch.arange(B, device=dev)
    n = window_lens.to(torch.int64).clamp(max=W)
    i = n - 1
    j = end[rows, i.clamp(min=0)].argmax(dim=1)
    cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    blocks = torch.zeros(B, max_blocks + 1, 4, dtype=torch.int32, device=dev)
    active = i >= 0
    while bool(active.any()):
        ic = i.clamp(min=0)
        s = spend[rows, ic, j].to(torch.int64)
        prev_col = end[rows, (s - 1).clamp(min=0)]  # [B, M]
        chain_s = prev_col.amax(dim=1)
        v = end[rows, ic, j]
        ident = torch.where(s > 0, v - chain_s, v)
        rec = torch.stack([j.to(torch.int32), s.to(torch.int32), ic.to(torch.int32), ident], dim=1)
        # inactive or overflowing windows write into the spare last slot
        slot = torch.where(active & (cnt < max_blocks), cnt, max_blocks)
        blocks[rows, slot] = rec
        nj = prev_col.argmax(dim=1)
        i = torch.where(active, s - 1, i)
        j = torch.where(active, nj, j)
        cnt = cnt + active.to(torch.int64)
        active = i >= 0
    return blocks[:, :max_blocks].contiguous(), cnt.to(torch.int32)


def build_window_batch(
    read_codes_list: list[np.ndarray], width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad encoded windows to a fixed width with READ_PAD (copy of the
    JAX package's helper, whose module imports jax)."""
    B = len(read_codes_list)
    out = np.full((B, width), READ_PAD, dtype=np.int8)
    lens = np.empty(B, dtype=np.int32)
    for b, rc in enumerate(read_codes_list):
        out[b, : len(rc)] = rc
        lens[b] = len(rc)
    return out, lens
