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
NEG16 = -(1 << 13)  # the int16 state's sentinel (chain_dp_pallas.py _neg)
INT32_MIN = -(1 << 31)  # the tiled bodies' empty carry: below every score
READ_PAD = 6  # never equals any monomer code (monomer pad is 5)
# A's variants of K1's lanes and cluster bodies (csrc/chain_dp_variant.cuh,
# csrc/chain_dp_ablate.cu); "base" is K1
VARIANTS = ("base", "nochain", "ladder4", "ladder2", "noemit", "noshift")


def state_neg(dtype: torch.dtype) -> int:
    """The sentinel below every reachable score, for the state type."""
    return NEG16 if dtype == torch.int16 else NEG


def int16_bounds_ok(W: int, L: int, ins, dele, mismatch, match) -> bool:
    """int16 state is safe iff no reachable intermediate can leave
    [-2^15, 2^15): magnitudes are bounded by (W + L)*max|unit| for real
    scores and by |NEG16| + L*max|unit| + one unit for the sentinel
    arithmetic (chain_dp_pallas.py _check_int16_bounds)."""
    unit = max(abs(x) for x in (ins, dele, mismatch, match))
    return (W + L) * unit + (1 << 13) + unit < (1 << 15)


def int16_sentinel_ok(W: int, L: int, ins, dele, mismatch, match) -> bool:
    """The port's own, stricter condition: every real score stays above the
    int16 sentinel -2^13. A score can fall to -(W + L)*max|unit| (a window
    that matches nothing); at k == 0 diag and ins are the sentinel, so a
    lower enter score would be stored as -2^13 and the blocks would come
    out wrong with no error. int16_bounds_ok admits (W + L)*unit up to
    ~24,500 and so does not exclude this; this condition implies it."""
    unit = max(abs(x) for x in (ins, dele, mismatch, match))
    return (W + L) * unit < (1 << 13) - unit


def resolve_state_dtype(state_dtype: str, W: int, L: int, ins, dele, mismatch,
                        match) -> torch.dtype:
    """"auto" and "int32" -> torch.int32; "int16" -> torch.int16 after the
    range checks, which raise for a window width W, monomer length L and
    scoring whose scores could wrap (chain_dp_pallas.py:404-418) or reach
    the int16 sentinel (int16_sentinel_ok: at unit scores, W + L < 8,191)."""
    if state_dtype in ("auto", "int32"):
        return torch.int32
    if state_dtype != "int16":
        raise ValueError(f"state_dtype must be 'int16', 'int32' or 'auto', got {state_dtype!r}")
    what = f"window={W}, monomer length={L}, scoring=({ins},{dele},{mismatch},{match})"
    if not int16_bounds_ok(W, L, ins, dele, mismatch, match):
        raise ValueError(
            f"state_dtype='int16' is unsafe for {what}: "
            "intermediate scores can leave [-2^15, 2^15). Use 'int32'."
        )
    if not int16_sentinel_ok(W, L, ins, dele, mismatch, match):
        raise ValueError(
            f"state_dtype='int16' is unsafe for {what}: scores can fall to the "
            "int16 sentinel -2^13 ((W + L) * max|score| must stay below "
            "2^13 - max|score|). Use 'int32'."
        )
    return torch.int16


def pair_scan(t: torch.Tensor, payloads: list[torch.Tensor], later_wins,
              steps: int | None = None) -> tuple:
    """Inclusive scan along the last axis of (t, *payloads) where a later
    element replaces the running one only if `later_wins(t_later, t_run)`
    (a strict comparison, so ties keep the EARLIEST payload); payloads have
    t's shape. torch.cummax/cummin keep the LAST index on ties, so their
    indices cannot carry the payload. For torch.gt (torch.lt) the running
    value is the running max (min), and an element takes over exactly
    where it beats the running value before it: the payload is the one at
    the last such index, a running max of their indices (a few launches a
    call). Other comparisons, and `steps` (the ladder ablations' cut scan
    over lane totals: that many doubling steps), take the log-step
    (Hillis-Steele) form."""
    n = t.shape[-1]
    running = _RUNNING.get(later_wins) if steps is None else None
    if running is not None and n > 1:
        best = running(t, dim=-1).values
        takes = torch.ones(t.shape, dtype=torch.bool, device=t.device)
        takes[..., 1:] = later_wins(t[..., 1:], best[..., :-1])
        idx = torch.arange(n, device=t.device).expand(t.shape)
        at = torch.cummax(torch.where(takes, idx, 0), dim=-1).values
        return best, [torch.gather(p, -1, at) for p in payloads]
    s, done = 1, 0
    while s < n and (steps is None or done < steps):
        ta, tb = t[..., :-s], t[..., s:]
        take_b = later_wins(tb, ta)
        t = torch.cat([t[..., :s], torch.where(take_b, tb, ta)], dim=-1)
        payloads = [
            torch.cat([p[..., :s], torch.where(take_b, p[..., s:], p[..., :-s])], dim=-1)
            for p in payloads
        ]
        s *= 2
        done += 1
    return t, payloads


# pair_scan's running value for a strict comparison
_RUNNING = {torch.gt: torch.cummax, torch.lt: torch.cummin}


def init_column(windows, mono_b, lens_b, dele, mismatch, match, dtype=torch.int32):
    """Column i = 0 (src/main.cpp:171-182): [B, M, L] scores in the state
    type. Its start pointers are all 0: the traceback closes the running
    block with start 0 when it reaches read position 0."""
    L = mono_b.shape[-1]
    k_del = torch.arange(L, dtype=dtype, device=windows.device) * dele
    read0 = windows[:, 0].to(torch.int32)[:, None, None]
    mm0 = torch.where(mono_b.to(torch.int32) == read0, match, mismatch).to(dtype)
    cand0 = (k_del - dele) + mm0
    cand0[:, :, 0] = mm0[:, :, 0]
    return torch.cummax(cand0 - k_del, dim=2).values + k_del


def broadcast_monomers(mono, mono_lens, B):
    """Shared [M, L] or per-window [B, M, L] monomers -> [B, M, L], [B, M]."""
    if mono.dim() == 2:
        return mono.expand(B, *mono.shape), mono_lens.expand(B, *mono_lens.shape)
    return mono, mono_lens


def sweep(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match):
    """The read-position loop from column 0 (`dp0`, [B, M, L] in the state
    type, start pointers 0): (chain [B, W] int32, end and spend [B, W, M] in
    the state type)."""
    B, W = windows.shape
    dev, dt = windows.device, dp0.dtype
    L = mono_b.shape[2]
    k_idx = torch.arange(L, dtype=torch.int32, device=dev)
    k_del = (k_idx * dele).to(dt)
    end_mask = k_idx == (lens_b.to(torch.int32)[:, :, None] - 1)  # [B, M, L]
    mono_i32 = mono_b.to(torch.int32)
    win_i32 = windows.to(torch.int32)
    neg = torch.tensor(state_neg(dt), dtype=dt, device=dev)

    def masked_ends(dp):
        return torch.where(end_mask, dp, neg).amax(dim=2)

    def gather_ends(x):  # one end cell per row, so a sum picks it
        return torch.where(end_mask, x, 0).sum(dim=2, dtype=dt)

    dp = dp0
    sp = torch.zeros_like(dp)
    chains = [torch.full((B,), INF, dtype=torch.int32, device=dev)]
    ends = [masked_ends(dp)]
    spends = [gather_ends(sp)]
    neg_col = torch.full_like(dp[:, :, :1], state_neg(dt))
    zero_col = torch.zeros_like(sp[:, :, :1])
    for i in range(1, W):
        mm = torch.where(mono_i32 == win_i32[:, i, None, None], match, mismatch).to(dt)
        chain_i = ends[-1].amax(dim=1)[:, None]  # [B, 1]
        prev_shift = torch.cat([neg_col, dp[:, :, :-1]], dim=2)
        sp_shift = torch.cat([zero_col, sp[:, :, :-1]], dim=2)
        enter = chain_i[:, :, None] + mm + k_del
        diag = prev_shift + mm
        diag[:, :, 0] = state_neg(dt)
        insr = dp + ins
        insr_c = insr.clone()
        insr_c[:, :, 0] = state_neg(dt)
        t = torch.maximum(enter, torch.maximum(diag, insr_c)) - k_del
        dp_new = torch.cummax(t, dim=2).values + k_del
        # payload as if this cell explains the score: ins (unguarded at
        # k == 0, like src/main.cpp:245), then diag, then enter
        candstart = torch.where(
            dp_new == insr, sp, torch.where(dp_new == diag, sp_shift, i)
        ).to(dt)
        _, (sp,) = pair_scan(t, [candstart], torch.gt)
        dp = dp_new
        chains.append(chain_i.amax(dim=1).to(torch.int32))
        ends.append(masked_ends(dp))
        spends.append(gather_ends(sp))
    return torch.stack(chains, dim=1), torch.stack(ends, dim=1), torch.stack(spends, dim=1)


class _LanesRows:
    """A set of rows stepped as K1's lanes body (csrc/chain_dp_lanes.cuh
    lanes_row) steps them; `sweep_lanes` and `sweep_cluster` share it. Each
    row is padded to 32 lanes x C = `cells_per_lane` cells (32 * C >= L);
    lane l owns cells l*C .. l*C + C - 1. At each position: the payload
    comes from the cell's own candidate, before the fold (ins, unguarded at
    k == 0; diag; enter); a sequential pair prefix runs within each lane;
    one pair scan over the 32 lane totals, shifted to an exclusive prefix,
    gives each lane what the earlier lanes hold, and a cell keeps its
    in-lane prefix only where it is strictly greater. Cells at or past a
    row's length are read as the sentinel with a mismatch, as in the kernel.
    Arithmetic is int32. `variant` is one of A's (VARIANTS; the kernels'
    kVariant, csrc/chain_dp_variant.cuh) for the changes made in a row's
    step: nochain takes each row's chain score from its own end cell at
    i - 1 (the `chain` given to `step` is not read), ladder4 / ladder2 stop
    the scan over the lane totals after 4 / 2 doubling steps, noshift takes
    diag from the cell's own value and pointer at i - 1. noemit changes no
    step (the caller drops the outputs)."""

    def __init__(self, windows, mono_b, lens_b, dp0, ins, dele, mismatch, match,
                 cells_per_lane, variant="base"):
        B = windows.shape[0]
        M, L = mono_b.shape[1], mono_b.shape[2]
        C = cells_per_lane
        P = 32 * C
        if P < L:
            raise ValueError(f"32 lanes x {C} cells do not cover L={L}")
        dev = windows.device
        self.neg = state_neg(dp0.dtype)
        i32 = torch.int32
        self.shape, self.C = (B, M, P), C
        self.k = torch.arange(P, dtype=i32, device=dev)
        self.kdel = self.k * dele
        self.n = lens_b.to(i32).clamp(0, L)[:, :, None]  # [B, M, 1]
        self.valid = self.k < self.n  # [B, M, P]
        codes = torch.full((B, M, P), -1, dtype=i32, device=dev)
        codes[:, :, :L] = mono_b.to(i32)
        self.codes = torch.where(self.valid, codes, -1)
        self.dp = torch.full((B, M, P), self.neg, dtype=i32, device=dev)
        self.dp[:, :, :L] = dp0.to(i32)
        self.sp = torch.zeros_like(self.dp)
        self.lane = torch.arange(32, device=dev)[:, None]
        self.end_idx = (self.n - 1).clamp(min=0).long()
        self.windows = windows
        self.scores = (ins, mismatch, match)
        self.variant = variant

    def emit(self):
        """(end, spend) [B, M] int32 of each row's end cell; rows of length
        0 emit (the sentinel, 0)."""
        has = self.n[:, :, 0] > 0
        return (torch.where(has, self.dp.gather(2, self.end_idx)[:, :, 0], self.neg),
                torch.where(has, self.sp.gather(2, self.end_idx)[:, :, 0], 0))

    def step(self, i: int, chain: torch.Tensor) -> None:
        """Read position i, from the chain score [B] int32 (the max of every
        row's end score at i - 1)."""
        self.fold(*self.candidates(i, chain))

    def candidates(self, i: int, chain: torch.Tensor) -> tuple:
        """Each cell's folded candidate t = cand - k*del and its payload at
        read position i, [B, M, 32 lanes, C] int32 each."""
        B, M, P = self.shape
        ins, mismatch, match = self.scores
        neg, k, kdel = self.neg, self.k, self.kdel
        p = torch.where(self.valid, self.dp, neg)
        ps = torch.where(self.valid, self.sp, 0)
        rc = self.windows[:, i].to(torch.int32)[:, None, None]
        mm = torch.where(self.codes == rc, match, mismatch).to(torch.int32)
        if self.variant == "noshift":  # the cell's own value and pointer at i - 1
            up_p, up_ps = p, ps
        else:
            up_p = torch.cat([torch.full_like(p[:, :, :1], neg), p[:, :, :-1]], dim=2)
            up_ps = torch.cat([torch.zeros_like(ps[:, :, :1]), ps[:, :, :-1]], dim=2)
        # nochain: each row's own end score at i - 1 [B, M]; else the max [B]
        chain = self.emit()[0] if self.variant == "nochain" else chain[:, None]
        enter = chain[:, :, None] + mm + kdel
        diag = torch.where(k == 0, neg, up_p + mm)
        ins_u = p + ins  # unguarded: the payload's ins check at k == 0
        cand = torch.maximum(enter, torch.maximum(diag, torch.where(k == 0, neg, ins_u)))
        cs = torch.where(cand == ins_u, ps, torch.where(cand == diag, up_ps, i))
        return (cand - kdel).view(B, M, 32, self.C), cs.view(B, M, 32, self.C)

    def fold(self, t: torch.Tensor, cs: torch.Tensor) -> None:
        """The row's new cells from the candidates: the in-lane pair prefix,
        the pair scan over the 32 lane totals (cut by the ladder variants),
        shifted to exclusive, and a cell's own prefix where strictly
        greater."""
        B, M, P = self.shape
        neg, kdel = self.neg, self.kdel
        run_t, run_c = t[..., 0], cs[..., 0]
        in_t, in_c = [run_t], [run_c]
        for c in range(1, self.C):  # later cell wins only when strictly greater
            take = t[..., c] > run_t
            run_t = torch.where(take, t[..., c], run_t)
            run_c = torch.where(take, cs[..., c], run_c)
            in_t.append(run_t)
            in_c.append(run_c)
        in_t, in_c = torch.stack(in_t, dim=-1), torch.stack(in_c, dim=-1)
        steps = {"ladder4": 4, "ladder2": 2}.get(self.variant)
        tot_t, (tot_c,) = pair_scan(run_t, [run_c], torch.gt, steps)  # inclusive, over lanes
        ex_t = torch.cat([torch.full_like(tot_t[..., :1], neg), tot_t[..., :-1]], dim=-1)[..., None]
        ex_c = torch.cat([torch.zeros_like(tot_c[..., :1]), tot_c[..., :-1]], dim=-1)[..., None]
        own = (self.lane == 0) | (in_t > ex_t)  # ties keep the earlier lanes
        self.dp = torch.where(own, in_t, ex_t).reshape(B, M, P) + kdel
        self.sp = torch.where(own, in_c, ex_c).reshape(B, M, P)


class _TiledRows:
    """A set of rows stepped as K1's tiled bodies (csrc/chain_dp_tiled.cu)
    step them; `sweep_tiled` and `sweep_cluster` (with `warps_per_row`)
    share it. Each row is padded to P = G warps x 32 lanes x C cells (P >=
    L); lane l of warp g owns cells k = g*32C + l*C + c. Stored, as in the
    kernel's shared memory: each cell's in-lane prefix of the last position
    and each lane's carry, (INT_MIN, 0) at column 0. At each position a cell's
    value at i - 1 is its stored prefix where that is strictly greater than
    its lane's carry, else the carry (the lazy fix-up); the diag neighbour of
    a lane's first cell is the previous lane's (or warp's) last cell at i - 1.
    Then: the payload from the cell's own candidate (ins, unguarded at k ==
    0; diag; enter); the sequential in-lane pair prefix, walked in tiles of
    `tile` cells with the prefix carried from tile to tile; one pair scan
    over each warp's 32 lane totals, shifted to an exclusive prefix; the
    warp's carry, the earliest argmax of the earlier warps' totals; and each
    lane's new carry, its warp's earlier lanes' prefix where strictly
    greater than the warp's carry, else that. A warp whose segment starts at
    or past its row's end (every warp of a row of length 0) skips the
    position and keeps its cells and carries. With `blocks` > 1 the row's
    warps span that many blocks (the grid route's split form, G / blocks
    warps each), and a warp's carry is read as that kernel reads the totals
    the row's warps push to the later blocks: the earliest argmax of the
    earlier warps', 32 at a time, an earlier group winning ties. Arithmetic
    is int32."""

    def __init__(self, windows, mono_b, lens_b, dp0, ins, dele, mismatch, match,
                 cells_per_lane, warps_per_row, tile, blocks=1):
        B = windows.shape[0]
        M, L = mono_b.shape[1], mono_b.shape[2]
        C, G = cells_per_lane, warps_per_row
        P = 32 * G * C
        if P < L or tile < 1:
            raise ValueError(f"{G} warps x 32 lanes x {C} cells do not cover L={L} "
                             f"(or tile {tile} < 1)")
        dev = windows.device
        i32 = torch.int32
        self.neg = state_neg(dp0.dtype)
        if blocks < 1 or G % blocks or (blocks - 1) * P // blocks >= max(L, 1):
            raise ValueError(f"{G} warps a row do not split into {blocks} blocks with cells "
                             f"below L={L}")
        self.shape, self.C, self.G, self.tile, self.blocks = (B, M, P), C, G, tile, blocks
        self.dele = dele
        k = torch.arange(P, dtype=i32, device=dev)
        self.n = lens_b.to(i32).clamp(0, L)[:, :, None]  # [B, M, 1]
        codes = torch.full((B, M, P), -1, dtype=i32, device=dev)
        codes[:, :, :L] = mono_b.to(i32)
        self.codes = codes.view(B, M, 32 * G, C)
        q = torch.full((B, M, P), self.neg, dtype=i32, device=dev)
        q[:, :, :L] = dp0.to(i32) - k[:L] * dele  # folded: q = dp - k * del
        self.q = q.view(B, M, 32 * G, C)  # [B, M, lane of the row, cell]
        self.s = torch.zeros_like(self.q)
        self.ct = torch.full((B, M, 32 * G), INT32_MIN, dtype=i32, device=dev)
        self.cc = torch.zeros_like(self.ct)
        self.first = (torch.arange(32 * G, device=dev) == 0)[:, None] & \
            (torch.arange(C, device=dev) == 0)  # [lanes, C]: k == 0
        self.end_idx = (self.n - 1).clamp(min=0).long()
        # [B, M, lanes of the row]: the lanes of warps whose segment starts
        # before the row's end
        starts = torch.arange(G, dtype=i32, device=dev).repeat_interleave(32) * (32 * C)
        self.live = starts < self.n
        self.windows = windows
        self.scores = (ins, mismatch, match)

    def values(self):
        """Every cell's (q, s) after the lazy fix-up: the state at the last
        position, [B, M, P]."""
        keep = self.q > self.ct[..., None]
        q = torch.where(keep, self.q, self.ct[..., None])
        s = torch.where(keep, self.s, self.cc[..., None])
        B, M, P = self.shape
        return q.reshape(B, M, P), s.reshape(B, M, P)

    def emit(self):
        """(end, spend) [B, M] int32 of each row's end cell, unfolded; rows of
        length 0 emit (the sentinel, 0)."""
        q, s = self.values()
        has = self.n[:, :, 0] > 0
        e = q.gather(2, self.end_idx)[:, :, 0] + self.end_idx[:, :, 0].to(torch.int32) * self.dele
        return torch.where(has, e, self.neg), torch.where(has, s.gather(2, self.end_idx)[:, :, 0], 0)

    def step(self, i: int, chain: torch.Tensor) -> None:
        """Read position i, from the chain score [B] int32 (the max of every
        row's end score at i - 1)."""
        B, M, P = self.shape
        C, G, neg = self.C, self.G, self.neg
        ins, mismatch, match = self.scores
        dele = self.dele
        qo, so = self.values()  # the cells at i - 1
        qo, so = qo.view(B, M, 32 * G, C), so.view(B, M, 32 * G, C)
        # the previous cell at i - 1: in the lane, else the previous lane's
        # (or warp's) last; none at k == 0
        up_q = torch.cat([torch.full_like(qo[:, :, :1, -1:], neg), qo[:, :, :-1, -1:]], dim=2)
        up_s = torch.cat([torch.zeros_like(so[:, :, :1, -1:]), so[:, :, :-1, -1:]], dim=2)
        rc = self.windows[:, i].to(torch.int32)[:, None, None, None]
        y = self.codes == rc
        enter = chain[:, None, None, None] + torch.where(y, match, mismatch).to(torch.int32)
        diag_add = torch.where(y, match - dele, mismatch - dele).to(torch.int32)
        run_t = torch.full_like(qo[..., 0], INT32_MIN)
        run_c = torch.zeros_like(run_t)
        new_q, new_s = [], []
        for c0 in range(0, C, self.tile):  # a tile's cells, the prefix carried between tiles
            for c in range(c0, min(C, c0 + self.tile)):
                first = self.first[:, c]
                if c > 0:
                    up_q, up_s = qo[..., c - 1 : c], so[..., c - 1 : c]
                diag = torch.where(first, neg, up_q[..., 0] + diag_add[..., c])
                ins_u = qo[..., c] + ins  # unguarded: the payload's ins check at k == 0
                t = torch.maximum(enter[..., c],
                                  torch.maximum(diag, torch.where(first, neg, ins_u)))
                cs = torch.where(t == ins_u, so[..., c], torch.where(t == diag, up_s[..., 0], i))
                take = t > run_t  # a later cell wins only when strictly greater
                run_t = torch.where(take, t, run_t)
                run_c = torch.where(take, cs, run_c)
                new_q.append(run_t)
                new_s.append(run_c)
        live = self.live[..., None]
        self.q = torch.where(live, torch.stack(new_q, dim=-1), self.q)
        self.s = torch.where(live, torch.stack(new_s, dim=-1), self.s)
        # each warp's 32 lane totals: inclusive pair scan, then exclusive
        tot_t, (tot_c,) = pair_scan(run_t.view(B, M, G, 32), [run_c.view(B, M, G, 32)], torch.gt)
        et = torch.cat([torch.full_like(tot_t[..., :1], INT32_MIN), tot_t[..., :-1]], dim=-1)
        ec = torch.cat([torch.zeros_like(tot_c[..., :1]), tot_c[..., :-1]], dim=-1)
        # each warp's carry: the earliest argmax of the earlier warps' totals
        if self.blocks == 1:
            wt, (wc,) = pair_scan(tot_t[..., -1], [tot_c[..., -1]], torch.gt)  # [B, M, G]
            wt = torch.cat([torch.full_like(wt[..., :1], INT32_MIN), wt[..., :-1]], dim=-1)
            wc = torch.cat([torch.zeros_like(wc[..., :1]), wc[..., :-1]], dim=-1)
        else:
            wt, wc = self.split_carry(tot_t[..., -1], tot_c[..., -1])
        wt, wc = wt[..., None], wc[..., None]
        later = et > wt  # the earlier warps win ties
        self.ct = torch.where(self.live, torch.where(later, et, wt).reshape(B, M, 32 * G), self.ct)
        self.cc = torch.where(self.live, torch.where(later, ec, wc).reshape(B, M, 32 * G), self.cc)

    @staticmethod
    def split_carry(tt, tc):
        """The split form's warp carries from the warp totals (tt, tc) [B,
        M, G]: for warp w, the earliest argmax of warps 0 .. w-1's, taken
        over groups of 32 warps in turn, a later group replacing the carry
        only where its max is strictly greater; (INT32_MIN, 0) for warp 0."""
        G = tt.shape[-1]
        w = torch.arange(G, device=tt.device)
        wt = torch.full_like(tt, INT32_MIN)
        wc = torch.zeros_like(tc)
        for j0 in range(0, G, 32):
            j = torch.arange(j0, min(G, j0 + 32), device=tt.device)
            read = j[None, :] < w[:, None]  # [G warps, the group's totals]
            vals = torch.where(read, tt[..., None, j0:j0 + len(j)], INT32_MIN)  # [B, M, G, n]
            mx, idx = vals.max(dim=-1)  # the first of the maxima
            mc = tc[..., j0:j0 + len(j)].gather(-1, idx)
            take = mx > wt
            wt = torch.where(take, mx, wt)
            wc = torch.where(take, mc, wc)
        return wt, wc


def _rows_sweep(rows, windows, dtype):
    """The read-position loop over one `_LanesRows` or `_TiledRows`:
    (chain [B, W] int32, end and spend [B, W, M] in `dtype`)."""
    W = windows.shape[1]
    chains = [torch.full((windows.shape[0],), INF, dtype=torch.int32, device=windows.device)]
    out = [rows.emit()]
    for i in range(1, W):
        chain = out[-1][0].amax(dim=1)
        rows.step(i, chain)
        chains.append(chain)
        out.append(rows.emit())
    return (torch.stack(chains, dim=1), torch.stack([e for e, _ in out], dim=1).to(dtype),
            torch.stack([s for _, s in out], dim=1).to(dtype))


def sweep_tiled(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match, cells_per_lane,
                warps_per_row, tile=8):
    """`sweep` computed as K1's tiled body (csrc/chain_dp_tiled.cu) splits
    it (`_TiledRows`: C = `cells_per_lane`, G = `warps_per_row`, register
    tiles of `tile` cells; the kernel's are ops/chain_dp_cuda.tiled_layout's
    and 8); test-only, nothing on the main path calls it. End and spend come
    out in dp0's type. Same outputs as `sweep`."""
    rows = _TiledRows(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match, cells_per_lane,
                      warps_per_row, tile)
    return _rows_sweep(rows, windows, dp0.dtype)


def sweep_lanes(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match, cells_per_lane):
    """`sweep` computed as K1's lanes body (csrc/chain_dp_lanes.cuh) splits
    it (`_LanesRows`, C = `cells_per_lane`); test-only, nothing on the main
    path calls it. End and spend come out in dp0's type. Same outputs as
    `sweep`."""
    rows = _LanesRows(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match, cells_per_lane)
    return _rows_sweep(rows, windows, dp0.dtype)


def sweep_cluster(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match, cluster_size,
                  cells_per_lane, warps_per_row=None, tile=8):
    """`sweep` computed as K1's cluster body (csrc/chain_dp_cluster.cuh)
    splits it, or with `warps_per_row` as the tiled cluster body
    (csrc/chain_dp_tiled.cu) does: `sweep_grid` on one group of cs =
    `cluster_size` slices, whose parity buffers hold every row's end score;
    test-only, nothing on the main path calls it. Same outputs as
    `sweep`."""
    return sweep_grid(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match, 1, cluster_size,
                      cells_per_lane, warps_per_row, tile)


def sweep_grid(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match, clusters, cluster_size,
               cells_per_lane, warps_per_row=None, tile=8, blocks_per_row=1, variant="base"):
    """`sweep` computed as K1's grid route (csrc/chain_dp_grid.cuh) splits
    it; test-only, nothing on the main path calls it. The window's rows go
    to K = `clusters` groups of cs = `cluster_size` slices (the blocks of a
    thread block cluster). S = `blocks_per_row` = 1: group k's slice r holds
    rows (k cs + r) R .. + R - 1, R = ceil(M / (K cs)), every slice at least
    one (else ValueError), stepped as the lanes body steps them
    (`_LanesRows`, C = `cells_per_lane`) or the tiled body (`_TiledRows`, G
    = `warps_per_row`, tiles of `tile`). S > 1 (the split form): a group
    holds cs / S whole rows, K cs / S = M, each row a `_TiledRows` over S
    blocks of G warps. Each group keeps the [2, Me] parity buffers of its
    own rows only (Me = cs R, or cs / S). At position i each group takes its
    max from its buffer (i - 1) & 1, the chain score is the max of the K
    group maxima (the kernel's exchange through global memory), and each
    group writes its rows' end scores into its buffer i & 1; rows of length
    0 are never written and keep the sentinel in both. End and spend come
    out in dp0's type. Same outputs as `sweep`; `variant` (the lanes form
    only) runs A's variant of each slice's step (`_LanesRows`)."""
    B, W = windows.shape
    M = mono_b.shape[1]
    K, cs, S = clusters, cluster_size, blocks_per_row
    if S == 1:
        blocks = K * cs
        R = -(-M // blocks) if blocks >= 1 else 0
        if K < 1 or cs < 1 or (blocks - 1) * R >= M:
            raise ValueError(f"{K} x {cs} slices of {R} rows leave a slice of M={M} rows empty")
        cuts, Me = [(j * R, min(M, (j + 1) * R)) for j in range(blocks)], cs * R
    else:
        if warps_per_row is None or cs < S or cs % S or K * (cs // S) != M:
            raise ValueError(f"{K} groups of {cs} blocks at {S} blocks a row do not hold "
                             f"M={M} rows (one each), or no warps_per_row")
        cuts, Me = [(m, m + 1) for m in range(M)], cs // S
    dev, neg = windows.device, state_neg(dp0.dtype)

    def slice_rows(a, z):
        args = (windows, mono_b[:, a:z], lens_b[:, a:z], dp0[:, a:z], ins, dele, mismatch, match,
                cells_per_lane)
        if warps_per_row is None:
            return _LanesRows(*args, variant)
        return _TiledRows(*args, warps_per_row * S, tile, S)

    slices = [slice_rows(a, z) for a, z in cuts]
    real = lens_b.to(torch.int32) > 0  # [B, M]: the rows that store an end score
    groups = [(k * Me, min(M, (k + 1) * Me)) for k in range(K)]
    ends0 = torch.cat([rows.emit()[0] for rows in slices], dim=1)
    bufs = []  # [B, 2, Me] each: the group's own rows, the sentinel past M
    for a, z in groups:
        buf = torch.full((B, 2, Me), neg, dtype=torch.int32, device=dev)
        buf[:, 0, : z - a] = ends0[:, a:z]
        bufs.append(buf)
    chains = [torch.full((B,), INF, dtype=torch.int32, device=dev)]
    out = [[rows.emit() for rows in slices]]
    for i in range(1, W):
        prev, cur = (i - 1) & 1, i & 1
        chain = torch.stack([buf[:, prev].amax(dim=1) for buf in bufs]).amax(dim=0)
        for rows in slices:
            rows.step(i, chain)
        out.append([rows.emit() for rows in slices])
        ends = torch.cat([e for e, _ in out[-1]], dim=1)
        for (a, z), buf in zip(groups, bufs):  # each group's rows into its own buffers
            buf[:, cur, : z - a] = torch.where(real[:, a:z], ends[:, a:z], buf[:, cur, : z - a])
        chains.append(chain)
    end = torch.stack([torch.cat([e for e, _ in o], dim=1) for o in out], dim=1)
    spend = torch.stack([torch.cat([s for _, s in o], dim=1) for o in out], dim=1)
    return torch.stack(chains, dim=1), end.to(dp0.dtype), spend.to(dp0.dtype)


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
    state_dtype: str = "auto",  # "int16" | "int32" | "auto" (= int32)
):
    """Chain DP + block walk over a batch of read windows. Returns
    (blocks[B, max_blocks, 4], counts[B]) int32; each record is
    (monomer_idx, start, end, identity) in window coordinates, last block
    first. state_dtype="int16" computes in int16 tensors with the int16
    sentinel (refused where scores could wrap or reach the sentinel: at
    unit scores W + L < 8,191); the debug arrays are int32 either way."""
    B, W = windows.shape
    if max_blocks == 0:
        max_blocks = W
    dt = resolve_state_dtype(state_dtype, W, mono.shape[-1], ins, dele, mismatch, match)
    mono_b, lens_b = broadcast_monomers(mono, mono_lens, B)
    dp0 = init_column(windows, mono_b, lens_b, dele, mismatch, match, dt)
    chain, end, spend = sweep(windows, mono_b, lens_b, dp0, ins, dele, mismatch, match)
    blocks, counts = block_walk(end, spend, window_lens, max_blocks)
    if return_debug:
        return blocks, counts, (chain, end.to(torch.int32), spend.to(torch.int32))
    return blocks, counts


def chain_dp_ablate(windows, mono, mono_lens, dp0, variant: str, ins=-1, dele=-1,
                    mismatch=-1, match=1, cluster_size: int | None = None):
    """Plain version of A, the ablation kernels (ops/chain_dp_cuda.
    chain_dp_ablate_cuda): K1's lanes body (`_LanesRows`, C = ceil(L / 32)),
    or with `cluster_size` its cluster body over that many slices
    (`sweep_grid`), from the given int32 column 0 with `variant`'s single
    change; noemit leaves 0 at every position but the last. Returns (end,
    spend) [B, W, M] int32; base is K1's, the others are knowingly not."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation variant {variant!r}; known: {', '.join(VARIANTS)}")
    mono_b, lens_b = broadcast_monomers(mono, mono_lens, windows.shape[0])
    args = (windows, mono_b, lens_b, dp0, ins, dele, mismatch, match)
    C = -(-mono.shape[-1] // 32)
    if cluster_size is None:
        _, end, spend = _rows_sweep(_LanesRows(*args, C, variant), windows, dp0.dtype)
    else:
        _, end, spend = sweep_grid(*args, 1, cluster_size, C, variant=variant)
    if variant == "noemit":
        end[:, :-1] = 0
        spend[:, :-1] = 0
    return end, spend


def block_walk(
    end: torch.Tensor,  # [B, W, M] state type (rows without cells end below all real)
    spend: torch.Tensor,  # [B, W, M] state type
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
        chain_s = prev_col.amax(dim=1).to(torch.int32)
        v = end[rows, ic, j].to(torch.int32)
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
