"""The contract of the three banded-alignment kernels (K4, K5, K6) and their
plain PyTorch twins, ported from stringdecomposer_tpu/ops/banded_pallas.py
(which imports jax, so nothing here imports it).

  K4  banded_final_column: the final target column of the banded NW DP,
      |i - j| <= k, [P, 2k+1] int32 (BIG outside the band and the rows).
      Its twin is ops/align.dp_banded_lastrow_batch itself, bit-equal on
      every lane; plain codes or equality bitmasks (use_mask).
  K5  banded_final_column_myers: the same column by bit-parallel banded
      Myers (32 band rows per word, a carry across words, the NW boundary
      inside the band). EXACT wherever the scan's value is <= k and >= it
      elsewhere; the twin transcribes the Pallas kernel and is bit-equal to
      it on every lane. Inputs are the <= 4-symbol compact codes of
      align._myers_compact_alphabet.
  K6  semi_ends_myers: full-height Myers over every target column, the
      end-row score D(q_len, j) for HW (free target prefix) or SHW. Exact;
      rows with q_len == 0 are wrong for SHW (callers special-case them).

The word planes hold uint32 values in int64 tensors, so every shift is
logical and every sum is taken mod 2^32 explicitly. Each twin uses
ceil(width / 32) words where the Pallas kernel pads to 128: the extra words
are zero or never reach a lower word (carries and up-shifts only move up),
so every output lane is the same.

Routing (ops/align.py's routers): DEFAULT_BACKEND = "scan" | "kernel" |
"auto". "auto" takes the K4/K5/K6 routes for CUDA tensors and the scans for
CPU tensors; "kernel" takes them on both devices (on the CPU the wrappers
in ops/banded_cuda.py run these twins); "scan" never.
"""

from __future__ import annotations

import torch

from .align import BIG, dp_banded_lastrow_batch

DEFAULT_BACKEND = "auto"

# minimum k for the bit-parallel route (K5); below it the int32 band K4
# serves. On the H100 (700 W; scripts/banded_ab.py: one 262,144 bp pair, a
# transposed SHW sweep of 4,096 columns, 64 pairs of 2,048 bp) K4's warp
# route beat K5 at k = 8, 16, 32 and 64 on every shape (at k = 64: 53.6
# against 62.4 ms, 0.88-0.94 against 1.10-1.15, 0.59-0.62 against
# 0.70-0.72); at k = 128 K5 won on two shapes (62.4 against 65.7 ms,
# 0.68-0.70 against 0.74-0.76) and tied on the third (1.07-1.13 against
# 1.06-1.08). On the 262,144 bp NW path's own sweeps (banded_ab.py
# --crossover) the kb = 64 level's one sweep (256 pairs of 2,056 x 1,025)
# took 0.295 ms on K4 and 0.396 on K5 alone, 1-2 ms and 12-15 ms as the
# path calls it (K5 adds its host remap); the kb = 128 level's three took
# 67.4 ms on K4 and 63.8 on K5. Tests and chip_smoke patch it down to force
# K5 on small cases.
MYERS_MIN_K = 128

M32 = 0xFFFFFFFF

# K4's twin: the banded scan, bit-equal on every lane
banded_final_column = dp_banded_lastrow_batch


def supported(P: int, Lq: int, Lt: int, k: int, eq_flat) -> bool:
    """K4 route eligibility: no lut-mode gather and a non-empty target."""
    return eq_flat is None and Lt > 0


def myers_supported(Lt: int, k: int, eq_flat, use_mask: bool) -> bool:
    """K5 route eligibility: plain codes, a non-empty target, k past the
    crossover."""
    return not use_mask and eq_flat is None and Lt > 0 and k >= MYERS_MIN_K


def semi_supported(P: int, Lq: int, eq_flat, use_mask: bool) -> bool:
    """K6 route eligibility: plain codes and a non-empty query width."""
    return not use_mask and eq_flat is None and Lq > 0


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., n] {0,1} -> [..., ceil(n/32)] words (bit b -> word b//32, bit
    b%32), uint32 values in int64."""
    n = bits.shape[-1]
    W = max(1, -(-n // 32))
    b = torch.zeros(bits.shape[:-1] + (W * 32,), dtype=torch.int64, device=bits.device)
    b[..., :n] = bits.to(torch.int64)
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (b.view(bits.shape[:-1] + (W, 32)) << sh).sum(dim=-1)


def as_uint32(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their uint32 values in int64."""
    return words.to(torch.int64) & M32


def _lowmask(widx: torch.Tensor, b0: int) -> torch.Tensor:
    """Per-word mask of global bits 0..b0 (empty if b0 < 0)."""
    n = (b0 + 1 - 32 * widx).clamp(0, 32)
    return torch.where(n >= 32, M32, (torch.ones_like(n) << n.clamp(max=31)) - 1)


def _words_up(v: torch.Tensor, s: int) -> torch.Tensor:
    """Word w <- word w - s, zero fill (carries and up-shifts move up)."""
    if s >= v.shape[1]:
        return torch.zeros_like(v)
    return torch.cat([torch.zeros_like(v[:, :s]), v[:, :-s]], dim=1)


def _down1(v: torch.Tensor) -> torch.Tensor:
    """Bit b <- bit b + 1 across the whole word vector."""
    nxt = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
    return (v >> 1) | ((nxt & 1) << 31)


def _up1(v: torch.Tensor, bit0: int) -> torch.Tensor:
    """Bit b <- bit b - 1; global bit 0 <- bit0."""
    out = ((v << 1) & M32) | (_words_up(v, 1) >> 31)
    out[:, 0] |= bit0
    return out


def _add_carry(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-word a + b (mod 2^(32 W)): word sums, then the carries by a
    Kogge-Stone prefix of (generate, propagate) along the word axis."""
    s = a + b
    gk = s >> 32
    s = s & M32
    pk = (s == M32).to(torch.int64)
    step = 1
    while step < a.shape[1]:
        gk = gk | (pk & _words_up(gk, step))
        pk = pk & _words_up(pk, step)
        step *= 2
    return (s + _words_up(gk, 1)) & M32


def _select_plane(planes: list[torch.Tensor], tc: torch.Tensor) -> torch.Tensor:
    """The Peq plane of target code tc [P, 1]; codes outside 0..3 match
    nothing."""
    eq = torch.zeros_like(planes[0])
    for c, plane in enumerate(planes):
        eq = torch.where(tc == c, plane, eq)
    return eq


def myers_query_codes(q: torch.Tensor, q_lens: torch.Tensor) -> torch.Tensor:
    """q [P, Lq] int32 with rows at or past q_len set to -9 (never a plane)."""
    row_i = torch.arange(q.shape[1], device=q.device)[None, :]
    return torch.where(row_i < q_lens.to(q.device)[:, None], q.to(torch.int32), -9)


def reconstruct_myers_column(cvp, cvn, ca, q_lens, t_lens, k: int) -> torch.Tensor:
    """The captured band from K5's state: anchor + cumsum of the vertical
    deltas (lane 0 = the anchor), BIG outside rows [0, q_len]. cvp/cvn are
    [P, W] uint32 values in int64, ca [P]. Returns [P, 2k+1] int32."""
    Bw = 2 * k + 1
    P, W = cvp.shape
    dev = cvp.device
    sh = torch.arange(32, dtype=torch.int64, device=dev)
    vpb = ((cvp[:, :, None] >> sh) & 1).reshape(P, W * 32)[:, :Bw]
    vnb = ((cvn[:, :, None] >> sh) & 1).reshape(P, W * 32)[:, :Bw]
    d = vpb - vnb
    vals = ca.to(torch.int64)[:, None] + torch.cumsum(d, dim=1) - d[:, :1]
    b_idx = torch.arange(Bw, dtype=torch.int64, device=dev)[None, :]
    i_cap = t_lens.to(device=dev, dtype=torch.int64)[:, None] + b_idx - k
    ok = (i_cap >= 0) & (i_cap <= q_lens.to(device=dev, dtype=torch.int64)[:, None])
    return torch.where(ok, vals, BIG).clamp(max=BIG).to(torch.int32)


def banded_final_column_myers(q, q_lens, t, t_lens, k: int) -> torch.Tensor:
    """K5's twin: transcribes banded_pallas._myers_kernel and its host
    wrapper (banded_final_column_myers). q [P, Lq], t [P, Lt] compact codes
    (q symbols 0..3, anything else never matches; t symbols 0..3). Returns
    [P, 2k+1] int32, bit-equal to the Pallas kernel on every lane."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    Bw = 2 * k + 1
    W = -(-Bw // 32)
    widx = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    lanemask = _lowmask(widx, Bw - 1)
    topw, topbit = (Bw - 1) // 32, 1 << ((Bw - 1) % 32)
    t = t.to(torch.int32)
    tl = t_lens.to(device=dev, dtype=torch.int64)[:, None]
    # query codes under the band: lane b at column 1 is q index b - k
    qmp = torch.full((P, Lq + k + 1 + Bw + Lt), -9, dtype=torch.int32, device=dev)
    qmp[:, k + 1 : k + 1 + Lq] = myers_query_codes(q, q_lens)
    init_rows = qmp[:, 1 : 1 + Bw]
    planes = [pack_bits(init_rows == c) for c in range(4)]
    qin = qmp[:, 1 + Bw : 1 + Bw + Lt]  # char entering the band top after column j
    # column 0: anchor k, a -1 ramp below row 0 (lanes 1..k), +1 above
    km = _lowmask(widx, k)
    vp = ((km ^ M32) & lanemask).expand(P, W)
    vn = (km & (_lowmask(widx, 0) ^ M32) & lanemask).expand(P, W)
    a = torch.full((P,), k, dtype=torch.int64, device=dev)
    cvp = torch.where(tl == 0, vp, 0)
    cvn = torch.where(tl == 0, vn, 0)
    ca = a.clone()
    not0 = torch.where(widx == 0, M32 ^ 1, M32)
    n_cols = min(Lt, int(tl.max())) if P else 0
    for j in range(1, n_cols + 1):
        b0 = k - j
        if b0 >= 0:
            bnd = torch.where(widx == b0 // 32, 1 << (b0 % 32), 0)
            low = _lowmask(widx, b0)
        else:
            bnd = low = torch.zeros_like(widx)
        eq = _select_plane(planes, t[:, j - 1 : j])
        vps = _down1(vp)
        vps[:, topw] |= topbit
        vns = _down1(vn)
        vps_c = vps & (low ^ M32)
        x = (eq | vns) & (low ^ M32)
        d0 = (_add_carry(x & vps_c, vps_c) ^ vps_c) | x
        hp = (vns | ((d0 | vps_c) ^ M32)) | bnd  # boundary row: h-delta forced +1
        hn = (d0 & vps_c) & (bnd ^ M32)
        hpsh = _up1(hp, 1)  # out-of-band cell above lane 0: +1
        hnsh = _up1(hn, 0)
        nvp = (hnsh | ((d0 | hpsh) ^ M32)) & lanemask
        nvn = (d0 & hpsh) & lanemask
        # virtual lanes strictly below the boundary keep the -1 ramp; the
        # boundary lane's own vertical delta is -1
        lowx = low & (bnd ^ M32)
        nob0 = bnd if b0 >= 1 else torch.zeros_like(bnd)
        nvp = nvp & (lowx ^ M32) & (nob0 ^ M32)
        nvn = ((nvn & (lowx ^ M32)) | (lowx & not0) | nob0) & lanemask
        # anchor: constant k while lane 0 is virtual (j <= k), tracked after
        if j > k:
            a = (a + ((vp[:, 0] >> 1) & 1) - ((vn[:, 0] >> 1) & 1)
                 + (hp[:, 0] & 1) - (hn[:, 0] & 1))
        vp, vn = nvp, nvn
        capm = j == tl
        cvp = torch.where(capm, vp, cvp)
        cvn = torch.where(capm, vn, cvn)
        ca = torch.where(capm[:, 0], a, ca)
        # slide the Peq planes one row down; the incoming top row's bits
        inc = qin[:, j - 1]
        for c in range(4):
            planes[c] = _down1(planes[c])
            planes[c][:, topw] |= (inc == c).to(torch.int64) * topbit
    return reconstruct_myers_column(cvp, cvn, ca, q_lens, t_lens, k)


def semi_ends_myers(q, q_lens, t, t_lens, free_target_prefix: bool = True) -> torch.Tensor:
    """K6's twin: transcribes banded_pallas._semi_kernel + semi_ends_myers.
    ends[p, j-1] = dist(q[p][:q_len], t[p][:j]) for j = 1..Lt under the HW
    (free target prefix) or SHW boundary, [P, Lt] int32; every column is
    computed, t_lens is not read (callers slice)."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    qm = myers_query_codes(q, q_lens)
    planes = [pack_bits(qm == c) for c in range(4)]  # static: rows are fixed
    W = planes[0].shape[1]
    widx = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    ql = q_lens.to(device=dev, dtype=torch.int64)[:, None]
    # one-hot of bit (q_len - 1); all zero when q_len == 0
    hot = torch.where((ql > 0) & (widx == (ql - 1) // 32), torch.ones_like(ql) << ((ql - 1) % 32), 0)
    hp0 = 0 if free_target_prefix else 1
    t = t.to(torch.int32)
    vp = torch.full((P, W), M32, dtype=torch.int64, device=dev)  # column 0: all +1
    vn = torch.zeros((P, W), dtype=torch.int64, device=dev)
    s = ql[:, 0].clone()  # D(q_len, 0) = q_len
    ends = torch.empty((P, Lt), dtype=torch.int32, device=dev)
    for j in range(Lt):
        x = _select_plane(planes, t[:, j : j + 1]) | vn
        d0 = (_add_carry(x & vp, vp) ^ vp) | x
        hp = vn | ((d0 | vp) ^ M32)
        hn = d0 & vp
        # end-row horizontal delta: the (at most one) hot bit of hp/hn
        s = s + ((hp & hot) != 0).sum(dim=1) - ((hn & hot) != 0).sum(dim=1)
        hpsh = _up1(hp, hp0)
        hnsh = _up1(hn, 0)
        vp = (hnsh | ((d0 | hpsh) ^ M32)) & M32
        vn = d0 & hpsh
        ends[:, j] = s.to(torch.int32)
    return ends


# ---------------------------------------------------------------------------
# The warp route's plain mirrors (test-only; nothing on the main path calls
# them): K5 and K6 as csrc/myers_warp.cu lays them out. Lane l of a pair's
# warp owns words l*R .. l*R + R - 1, held here as [P, 32, R] planes.
# ---------------------------------------------------------------------------
def carry_in_lanes(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The carry into each of 32 lanes, [..., 32] 0/1, from the lanes'
    (generate, propagate) bits [..., 32] (exclusive), as the kernel takes
    it: the ballots G and P as 32-bit masks, A = G | P, and bit l of
    (A + G) ^ A ^ G; no carry enters lane 0."""
    sh = torch.arange(32, dtype=torch.int64, device=g.device)
    G = (g.to(torch.int64) << sh).sum(dim=-1, keepdim=True)
    A = G | (p.to(torch.int64) << sh).sum(dim=-1, keepdim=True)
    return ((((A + G) & M32) ^ A ^ G) >> sh) & 1


def peq_bitmaps(q: torch.Tensor, q_lens: torch.Tensor, off: int, NB: int) -> torch.Tensor:
    """The kernels' prologue: per-code bitmaps of the query, [P, 4, NB]
    uint32 values in int64; bit b of word m of plane c is set where query
    index 32 m + b - off (below min(q_len, Lq)) holds code c."""
    P, Lq = q.shape
    dev = q.device
    idx = torch.arange(32 * NB, device=dev)[None, :] - off
    ok = (idx >= 0) & (idx < q_lens.to(device=dev, dtype=torch.int64)[:, None]) & (idx < Lq)
    codes = torch.full((P, 32 * NB), -9, dtype=torch.int64, device=dev)
    if Lq:
        got = q.to(torch.int64).gather(1, idx.clamp(0, Lq - 1).expand(P, -1))
        codes = torch.where(ok, got, codes)
    return torch.stack([pack_bits(codes == c) for c in range(4)], dim=1)


def lane_carries(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """The carry into each of the warp's words, [P, 32, R] 0/1, from the
    words' generate and propagate bits [P, 32, R] (exclusive), as the
    kernel's lane_carries takes it: a lane's words as R-bit masks G and P,
    A = G | P, its carry out bit R of A + G and its propagate P == all ones;
    the carry c into the lane from the ballots (carry_in_lanes); bit r of
    (A + G + c) ^ A ^ G the carry into word r."""
    R = gen.shape[2]
    sh = torch.arange(R, dtype=torch.int64, device=gen.device)
    gm = (gen << sh).sum(dim=-1)
    pm = (prop << sh).sum(dim=-1)
    am = gm | pm
    c = carry_in_lanes(((am + gm) >> R) & 1, (pm == (1 << R) - 1).to(torch.int64))
    return (((am + gm + c) ^ am ^ gm)[..., None] >> sh) & 1


def _warp_add(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(x & v) + v over the warp's words with the carries of lane_carries;
    [P, 32, R] in, the sum mod 2^(32 * 32R) out."""
    full = (x & v) + v
    part, gen = full & M32, full >> 32
    prop = (part == M32).to(torch.int64)
    return (part + lane_carries(gen, prop)) & M32


def _shift_up(h: torch.Tensor, bit0: int) -> torch.Tensor:
    """Bit b <- bit b - 1 over the warp's words: within a lane from its word
    below, across lanes bit 31 of the lane below's last word (the shuffle
    up); lane 0's word 0 takes bit0."""
    top = h[:, :, -1:] >> 31
    below = torch.cat([torch.full_like(top[:, :1], bit0), top[:, :-1]], dim=1)
    return ((h << 1) & M32) | torch.cat([below, h[:, :, :-1] >> 31], dim=2)


def _shift_down(v: torch.Tensor) -> torch.Tensor:
    """Bit b <- bit b + 1 over the warp's words: bit 0 of the word above,
    across lanes of the next lane's first word (the shuffle down; lane 31
    takes 0)."""
    nxt = torch.cat([v[:, 1:, :1], torch.zeros_like(v[:, :1, :1])], dim=1)
    return (v >> 1) | (torch.cat([v[:, :, 1:], nxt], dim=2) & 1) << 31


def _lane_words(W: int, R: int | None) -> int:
    need = max(1, -(-W // 32))
    if R is None:
        return need
    if R < need:
        raise ValueError(f"R = {R} words a lane cannot hold {W} words")
    return R


def myers_warp(q, q_lens, t, t_lens, k: int, R: int | None = None) -> torch.Tensor:
    """K5 as its warp route computes it, [P, 2k+1] int32 (bit-equal to
    banded_final_column_myers on every lane): lane strips of R words
    (default ceil(W / 32); any R that holds W words), the slide's and the
    up-shift's seams across lanes, the carries of lane_carries, and the Peq
    words as a funnel shift, at offset j, of the query's per-code bitmaps
    over absolute rows (bit p = query index p - k - 1). As in the kernel,
    bits above the band's top lane are left unmasked (they only move up)
    and the slide forces the top lane's entering bits; the capture masks
    them."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    Bw = 2 * k + 1
    W = -(-Bw // 32)
    R = _lane_words(W, R)
    widx = (torch.arange(32, device=dev)[:, None] * R
            + torch.arange(R, device=dev)[None, :]).to(torch.int64)  # [32, R]
    lm = _lowmask(widx, Bw - 1)
    topw, topbit = (Bw - 1) // 32, 1 << ((Bw - 1) % 32)
    top = torch.where(widx == topw, topbit, 0)
    not0 = torch.where(widx == 0, M32 ^ 1, M32)
    # column 0: anchor k, a -1 ramp below row 0 (lanes 1..k), +1 above
    km = _lowmask(widx, k)
    vp = ((km ^ M32) & lm).expand(P, 32, R).clone()
    vn = (km & (_lowmask(widx, 0) ^ M32) & lm).expand(P, 32, R).clone()
    NB = (k + Lq + 32) // 32 + 1
    bm = peq_bitmaps(q, q_lens, k + 1, NB)
    bm = torch.cat([bm, torch.zeros_like(bm[:, :, :1]).expand(P, 4, 32 * R + 2)], dim=2)
    tl = t_lens.to(device=dev, dtype=torch.int64)
    n = torch.where((tl < 0) | (tl > Lt), -1, tl)
    a = torch.full((P,), k, dtype=torch.int64, device=dev)
    cvp = torch.where((n == 0)[:, None, None], vp, 0)
    cvn = torch.where((n == 0)[:, None, None], vn, 0)
    ca = a.clone()
    t64 = t.to(device=dev, dtype=torch.int64)
    pidx = torch.arange(P, device=dev)
    for j in range(1, (min(Lt, int(n.max())) if P else 0) + 1):
        tc = t64[:, j - 1]
        plane = bm[pidx, tc.clamp(0, 3)]  # [P, NB + pad]
        lo = plane[:, (j >> 5) + widx]
        hi = plane[:, (j >> 5) + widx + 1]
        s = j & 31
        eq = lo if s == 0 else ((lo >> s) | (hi << (32 - s))) & M32
        eq = torch.where(((tc >= 0) & (tc < 4))[:, None, None] & (widx < W), eq, 0)
        b0 = k - j
        low = _lowmask(widx, b0) if b0 >= 0 else torch.zeros_like(widx)
        bnd = torch.where(widx == b0 // 32, 1 << (b0 % 32), 0) if b0 >= 0 else torch.zeros_like(widx)
        vps = (_shift_down(vp) | top) & (low ^ M32)
        vns = _shift_down(vn) & (top ^ M32)
        x = (eq | vns) & (low ^ M32)
        d0 = (_warp_add(x, vps) ^ vps) | x
        hp = (vns | ((d0 | vps) ^ M32)) | bnd  # boundary row: +1
        hn = (d0 & vps) & (bnd ^ M32)
        hpsh = _shift_up(hp, 1)  # out-of-band cell above lane 0: +1
        hnsh = _shift_up(hn, 0)
        lowx = low & (bnd ^ M32)
        nob0 = bnd if b0 >= 1 else torch.zeros_like(bnd)
        nvp = (hnsh | ((d0 | hpsh) ^ M32)) & (lowx ^ M32) & (nob0 ^ M32) & M32
        nvn = ((d0 & hpsh) & (lowx ^ M32)) | (lowx & not0) | nob0
        if b0 < 0 and Bw >= 2:  # the anchor follows lane 0's word 0 once j > k
            a = a + ((vp[:, 0, 0] >> 1) & 1) - ((vn[:, 0, 0] >> 1) & 1)
        if b0 < 0:
            a = a + (hp[:, 0, 0] & 1) - (hn[:, 0, 0] & 1)
        vp, vn = nvp, nvn
        cap = n == j
        cvp = torch.where(cap[:, None, None], vp & lm, cvp)
        cvn = torch.where(cap[:, None, None], vn & lm, cvn)
        ca = torch.where(cap, a, ca)
    return reconstruct_myers_column(cvp.reshape(P, 32 * R)[:, :W], cvn.reshape(P, 32 * R)[:, :W],
                                    ca, q_lens, t_lens, k)


def semi_warp(q, q_lens, t, free_target_prefix: bool = True, R: int | None = None,
              seg_cols: int = 0) -> torch.Tensor:
    """K6 as its warp route computes it, [P, Lt] int32 (equal to
    semi_ends_myers): lane strips of R words with the Peq words fixed a
    lane, the carries of lane_carries, the up-shift's seam across lanes. With seg_cols = S > 0 (HW only), warp g runs segment
    g % nseg of pair g // nseg: it starts fresh at column max(0, e_s -
    2 q_len) and writes ends e_s .. e_s + S - 1 only (csrc/myers_warp.cu
    semi_warp_kernel says why that is exact)."""
    if seg_cols and not free_target_prefix:
        raise ValueError("SHW fixes the alignment's start at column 0: no segments")
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    W = max(1, -(-Lq // 32))
    R = _lane_words(W, R)
    pq = torch.zeros((P, 4, 32 * R), dtype=torch.int64, device=dev)
    pq[:, :, :W] = peq_bitmaps(q, q_lens, 0, W)
    pq = pq.view(P, 4, 32, R)
    nseg, S = (-(-Lt // seg_cols), seg_cols) if seg_cols else (1, Lt)
    g = torch.arange(P * nseg, device=dev)
    pw = g // nseg
    e_s = (g % nseg) * S
    e_e = (e_s + S).clamp(max=Lt)
    ql = q_lens.to(device=dev, dtype=torch.int64)[pw]
    j0 = (e_s - 2 * ql).clamp(min=0)
    hot_w = torch.where(ql > 0, (ql - 1) // 32, -1)
    has_hot = (hot_w >= 0) & (hot_w < W)
    hot_lane, hot_r = (hot_w // R).clamp(0, 31), (hot_w % R).clamp(0, R - 1)
    hot_b = (ql - 1) & 31
    hp0 = 0 if free_target_prefix else 1
    vp = torch.full((len(g), 32, R), M32, dtype=torch.int64, device=dev)  # column j0: all +1
    vn = torch.zeros_like(vp)
    score = ql.clone()
    ends = torch.zeros((P, Lt), dtype=torch.int32, device=dev)
    t64 = t.to(device=dev, dtype=torch.int64)
    steps = e_e - j0
    for i in range(int(steps.max()) if len(g) and Lt else 0):
        j = j0 + i
        act = i < steps
        tc = t64[pw, j.clamp(max=Lt - 1)]
        eq = pq[pw, tc.clamp(0, 3)]
        eq = torch.where(((tc >= 0) & (tc < 4))[:, None, None], eq, 0)
        x = eq | vn
        d0 = (_warp_add(x, vp) ^ vp) | x
        hp = vn | ((d0 | vp) ^ M32)
        hn = d0 & vp
        at = (g, hot_lane, hot_r)
        delta = ((hp[at] >> hot_b) & 1) - ((hn[at] >> hot_b) & 1)
        hpsh = _shift_up(hp, hp0)  # row 0: HW 0, SHW +1
        hnsh = _shift_up(hn, 0)
        m = act[:, None, None]
        vp = torch.where(m, (hnsh | ((d0 | hpsh) ^ M32)) & M32, vp)
        vn = torch.where(m, d0 & hpsh, vn)
        score = torch.where(act & has_hot, score + delta, score)
        out = act & (j >= e_s)
        ends[pw[out], j[out]] = score[out].to(torch.int32)
    return ends


# ---------------------------------------------------------------------------
# K4's warp route and K6's wide route as plain mirrors (test-only; nothing on
# the main path calls them)
# ---------------------------------------------------------------------------
def banded_warp(q, q_lens, t, t_lens, k: int, R: int | None = None,
                use_mask: bool = False) -> torch.Tensor:
    """K4 as its warp route (csrc/banded_warp.cu) computes it, [P, 2k+1]
    int32, bit-equal to banded_final_column on every lane. The band's lanes
    in lane strips of R cells, [P, 32, R] (default ceil((2k + 1) / 32); any
    R that holds the band), the cells past the band BIG. A cell's left
    neighbour is the next cell, or for a strip's last the next lane's first
    (the shuffle down; lane 31 takes BIG). The up chain: cand - b's minimum
    over each strip, an inclusive min scan of the totals over five shuffle-up
    steps (a lane below the offset keeps its own), shifted one lane up
    (INT_MAX into lane 0), then the running minimum along the strip from it.
    The query codes slide down one cell a column, lane 31's last cell taking
    the row that enters the band's top."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    Bw = 2 * k + 1
    R = _lane_words(Bw, R)
    b = (torch.arange(32, device=dev)[:, None] * R
         + torch.arange(R, device=dev)[None, :]).to(torch.int64)  # [32, R]
    ql = q_lens.to(device=dev, dtype=torch.int64)[:, None, None]
    i0 = b - k
    D = torch.where((b < Bw) & (i0 >= 0) & (i0 <= ql), i0, BIG)  # column 0
    # the query codes by index x at x + off, the padding code outside [0, Lq)
    off = k + 1
    qpad = torch.full((P, off + Lq + 32 * R + Lt + 1), 0 if use_mask else -1,
                      dtype=torch.int32, device=dev)
    qpad[:, off : off + Lq] = q.to(torch.int32)
    code = qpad[:, i0 + off]  # [P, 32, R]: band lane b's code at column 1, index b - k
    tl = t_lens.to(device=dev, dtype=torch.int64)
    n = torch.where((tl < 0) | (tl > Lt), -1, tl)
    cap = torch.where((n == 0)[:, None, None], D, BIG)
    t32 = t.to(device=dev, dtype=torch.int32)
    big = torch.full((P, 1, 1), BIG, dtype=torch.int64, device=dev)
    for j in range(1, (int(n.max()) if P else 0) + 1):
        tc = t32[:, j - 1][:, None, None]
        qin = qpad[:, j + 32 * R - k - 1 + off]  # the row entering the top after column j
        right = torch.cat([D[:, 1:, :1], big], dim=1)
        dl = torch.cat([D[:, :, 1:], right], dim=2)
        sub = (1 - ((code >> tc) & 1)) if use_mask else (code != tc).to(torch.int32)
        cand = torch.minimum(dl + 1, D + sub.to(torch.int64))
        i = j + b - k
        lim = torch.minimum(ql, torch.full_like(ql, j + k))
        cand = torch.where(i == 0, j, cand)  # the NW boundary row
        cand = torch.where((i < 0) | (i > lim), BIG, cand)
        c = cand - b
        run = c.min(dim=2).values  # [P, 32]
        for o in (1, 2, 4, 8, 16):
            run = torch.minimum(run, torch.cat([run[:, :o], run[:, :-o]], dim=1))
        excl = torch.cat([torch.full_like(run[:, :1], 2**31 - 1), run[:, :-1]], dim=1)
        pre = torch.minimum(excl[:, :, None], torch.cummin(c, dim=2).values)
        D = torch.where((i >= 0) & (i <= lim), pre + b, BIG)
        up = torch.cat([code[:, 1:, :1], qin[:, None, None]], dim=1)
        code = torch.cat([code[:, :, 1:], up], dim=2)
        cap = torch.where((n == j)[:, None, None], D, cap)
    return cap.reshape(P, 32 * R)[:, :Bw].clamp(max=BIG).to(torch.int32)


def semi_staged(q, q_lens, t, free_target_prefix: bool = True, stages: int | None = None,
                seg_cols: int = 0) -> torch.Tensor:
    """K6 as its wide route (csrc/banded.cu semi_wide_kernel) computes it,
    [P, Lt] int32, equal to semi_ends_myers. The query's words in stages of
    WIDE_R (ops/hw_filter), `stages` a band (default wide_shape's; any
    number here), run as the kernel's pipeline: at step u stage s steps
    column u - s on its words (the add's carry rippling through them from
    the link's carry in) and hands stage s + 1 its link, the carry out and
    the HP / HN bits of its top row; a stage that does not step hands on the
    link it got. Stage 0 of band 0 takes row 0's horizontal delta (HW 0, SHW
    +1), of a later band the band below's top links, kept by column. Only
    the stages up to the end row's (bit q_len - 1) run; the stage holding it
    keeps the score. With seg_cols = S > 0 (HW only), block g runs segment
    g % nseg of pair g // nseg from column max(0, e_s - 2 q_len), as
    semi_warp."""
    from .hw_filter import WIDE_R, wide_shape

    if seg_cols and not free_target_prefix:
        raise ValueError("SHW fixes the alignment's start at column 0: no segments")
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    W = max(1, -(-Lq // 32))
    st = stages or wide_shape(Lq)[0]
    bands = -(-W // (st * WIDE_R))
    pq = torch.zeros((P, 4, bands * st * WIDE_R), dtype=torch.int64, device=dev)
    pq[:, :, :W] = peq_bitmaps(q, q_lens, 0, W)
    nseg, S = (-(-Lt // seg_cols), seg_cols) if seg_cols else (1, Lt)
    g = torch.arange(P * nseg, device=dev)
    pw = g // nseg
    e_s = (g % nseg) * S
    e_e = (e_s + S).clamp(max=Lt)
    ql = q_lens.to(device=dev, dtype=torch.int64)[pw]
    j0 = (e_s - 2 * ql).clamp(min=0)
    ncols = e_e - j0
    hot_w = torch.where(ql > 0, (ql - 1) // 32, -1)
    has = (hot_w >= 0) & (hot_w < W)
    hs = hot_w.clamp(min=0) // WIDE_R
    hb, hsl = hs // st, hs % st
    hot_r, hot_b = hot_w.clamp(min=0) % WIDE_R, (ql - 1) & 31
    ends = torch.zeros((P, Lt), dtype=torch.int32, device=dev)
    for gi in torch.nonzero(~has).flatten().tolist():  # no end row among the words
        ends[pw[gi], int(e_s[gi]) : int(e_e[gi])] = int(ql[gi])
    score = ql.clone()
    sidx = torch.arange(st, device=dev)
    tops = torch.zeros((len(g), max(1, int(ncols.max()) if len(g) else 1)), dtype=torch.int64,
                       device=dev)
    t64 = t.to(device=dev, dtype=torch.int64)
    for band in range(int(hb[has].max()) + 1 if bool(has.any()) else 0):
        used = torch.where(has & (band <= hb), torch.where(band < hb, st, hsl + 1), 0)
        words = pq[pw][:, :, band * st * WIDE_R : (band + 1) * st * WIDE_R]
        words = words.reshape(len(g), 4, st, WIDE_R)
        vp = torch.full((len(g), st, WIDE_R), M32, dtype=torch.int64, device=dev)
        vn = torch.zeros_like(vp)
        handed = torch.zeros((len(g), st), dtype=torch.int64, device=dev)
        hot = (band == hb) & has
        for u in range(int((ncols + used - 1).max())):
            c = (u - sidx).expand(len(g), st)  # [G, stages]
            act = (sidx[None, :] < used[:, None]) & (c >= 0) & (c < ncols[:, None])
            cc = c.clamp(min=0)
            if band == 0:
                l0 = torch.full_like(g, 0 if free_target_prefix else 2)
            else:
                l0 = tops[g, cc[:, 0].clamp(max=tops.shape[1] - 1)]
            link = torch.cat([l0[:, None], handed[:, :-1]], dim=1)
            tc = t64[pw[:, None], (j0[:, None] + cc).clamp(max=Lt - 1)]
            eq = torch.zeros_like(vp)
            for code in range(4):
                eq = torch.where((tc == code)[..., None], words[:, code], eq)
            x = eq | vn
            carry = link & 1
            hpp, hnp = (link >> 1) & 1, (link >> 2) & 1
            nvp, nvn, hp_w, hn_w = [], [], [], []
            for r in range(WIDE_R):
                full = (x[..., r] & vp[..., r]) + vp[..., r] + carry
                carry, sm = full >> 32, full & M32
                d0 = (sm ^ vp[..., r]) | x[..., r]
                hp = vn[..., r] | ((d0 | vp[..., r]) ^ M32)
                hn = d0 & vp[..., r]
                hpsh = ((hp << 1) & M32) | hpp
                hnsh = ((hn << 1) & M32) | hnp
                nvp.append((hnsh | ((d0 | hpsh) ^ M32)) & M32)
                nvn.append(d0 & hpsh)
                hp_w.append(hp)
                hn_w.append(hn)
                hpp, hnp = hp >> 31, hn >> 31
            out = carry | (hpp << 1) | (hnp << 2)
            m = act[..., None]
            vp = torch.where(m, torch.stack(nvp, dim=-1), vp)
            vn = torch.where(m, torch.stack(nvn, dim=-1), vn)
            handed = torch.where(act, out, link)
            # the end row's stage keeps the score
            hsl_c = hsl.clamp(max=st - 1)
            on = hot & act[g, hsl_c]
            hpw, hnw = torch.stack(hp_w, dim=-1), torch.stack(hn_w, dim=-1)
            delta = (((hpw[g, hsl_c, hot_r] >> hot_b) & 1)
                     - ((hnw[g, hsl_c, hot_r] >> hot_b) & 1))
            score = torch.where(on, score + delta, score)
            j = j0 + c[g, hsl_c]
            w = on & (j >= e_s)
            ends[pw[w], j[w]] = score[w].to(torch.int32)
            # the band's top links, kept by column for the next band
            top = act[:, st - 1] & (band < hb)
            tops[g[top], c[top, st - 1]] = out[top, st - 1]
    return ends


# ---------------------------------------------------------------------------
# K4's and K5's wide routes as plain mirrors (test-only; nothing on the main
# path calls them): pipelines of register stages in absolute rows
# (csrc/banded.cu banded_wide_kernel, myers_wide_kernel)
# ---------------------------------------------------------------------------
WIDE4_R = 32  # K4's wide route: rows a stage (csrc/banded.cu kRows4)
K4_CLUSTER_MAX = 8  # K4's wide route: blocks a pair, a band each (csrc/banded.cu kClusterMax)
# K4's wide route: stages a band at most. A step of a band costs about the
# same at 4 warps as at 16 (its link's chain, ~500 ns on the H100), so
# smaller bands run more of the band's rows at once on a cluster: on the
# H100, banded_ab.py --k4-stages measured 128 the fastest of 32 .. 512 on
# the 262,144 bp pair at k = 256 and 1,024, on 64 pairs of 32,768 bp at k =
# 256 and on the 40 kbp pair at k = 8,192
WIDE4_STAGES = 128
INF_G = 1 << 29  # K4's wide route: a cell past the band or the rows (D - i - j >= BIG)


def _wide_stages(units: int, per_stage: int) -> int:
    """Threads of a wide-route block: stages of per_stage rows or words for
    `units` of them, whole warps, at most ops/hw_filter.WIDE_MAX_STAGES
    (past that the kernel runs bands of stages)."""
    from .hw_filter import WIDE_MAX_STAGES

    return min(WIDE_MAX_STAGES, 32 * max(1, -(-units // (32 * per_stage))))


def banded_wide_shape(Lq: int, Lt: int, k: int,
                      stages: int | None = None) -> tuple[int, int, int]:
    """(stages a band, seams, blocks a pair) of K4's wide route: rows 0 ..
    min(q_len, t_len + k), rows = min(Lq, Lt + k) + 1 at most, in stages of
    WIDE4_R, WIDE4_STAGES a band at most (or `stages` given). A pair past
    one band of RB = stages * WIDE4_R rows runs its bands at once: band b +
    1 starts about RB + stages columns after band b and runs RB + 2k +
    stages, so cs = 1 + ceil(2k / RB) blocks, one a band (each every cs-th
    band past that), keep up with the bands, at most K4_CLUSTER_MAX and the
    bands. `seams`, the most bands a pair can take less one, sizes the top
    links' scratch, 2k + 1 links a seam."""
    rows = min(Lq, Lt + k) + 1
    stages = stages or min(_wide_stages(rows, WIDE4_R), WIDE4_STAGES)
    RB = stages * WIDE4_R
    bands = -(-rows // RB)
    return stages, bands - 1, min(K4_CLUSTER_MAX, bands, 1 + -(-2 * k // RB))


def myers_wide_stages(Lq: int, Lt: int, k: int) -> tuple[int, bool]:
    """(stages a band, whether a pair may take more than one band) of K5's
    wide route: offset rows a = i + k up to min(q_len + k, t_len + 2k), in
    32-row words, in stages of WIDE_R words (ops/hw_filter.WIDE_R)."""
    from .hw_filter import WIDE_R

    words = min(Lq + k, Lt + 2 * k) // 32 + 1
    stages = _wide_stages(words, WIDE_R)
    return stages, words > stages * WIDE_R


def banded_staged(q, q_lens, t, t_lens, k: int, rows: int | None = None,
                  stages: int | None = None, use_mask: bool = False) -> torch.Tensor:
    """K4 as its wide route computes it, [P, 2k+1] int32, bit-equal to
    banded_final_column on every lane. Absolute rows i in stages of `rows`
    (default WIDE4_R), `stages` a band (default banded_wide_shape's), each
    cell held as G = D(i, j) - i - j: the left step costs 0, the diagonal
    sub - 2, the up step 0, so the up chain is a running minimum and the NW
    boundary row stays G = 0. Only rows up to min(q_len, t_len + k) are
    held; a band runs the columns where some of its rows lie in the band.
    At step u stage s steps column jb + u - s: cand = min(G(i, j - 1),
    G(i - 1, j - 1) + sub - 2) from its own rows (the first row's diagonal
    the previous link), then the running minimum from the link, the top
    row's G of the stage below at this column, into the stage's rows.
    Cells past the band's top keep INF_G (so a row entering it reads exactly
    BIG from its left, as band_cand), the chain restarts at the band's
    bottom (rows below it hold stale values and the link from below them is
    dropped), stages wholly outside the band do nothing, and a band's top
    links are kept for the next band (which the kernel runs at the same
    time on another block of a cluster, waiting for the columns it reads)
    at the 2k + 1 columns it reads, A - k - 1 .. A + k - 1 for its first
    row A. At j = t_len each stage writes its rows of the band: min(G + i +
    t_len, BIG)."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    R = rows or WIDE4_R
    S = stages or banded_wide_shape(Lq, Lt, k)[0]
    Bw = 2 * k + 1
    ql = q_lens.to(device=dev, dtype=torch.int64)
    tl = t_lens.to(device=dev, dtype=torch.int64)
    n = torch.where((tl < 0) | (tl > Lt), -1, tl)
    out = torch.full((P, Bw), BIG, dtype=torch.int64, device=dev)
    last = torch.minimum(ql, n + k)  # the highest row any captured lane needs
    RB = S * R
    nb = torch.where((n >= 0) & (last >= 0), last // RB + 1, 0)
    # the code of row i at index i: the padding code at row 0 and past Lq
    qpad = torch.full((P, Lq + 2), 0 if use_mask else -1, dtype=torch.int64, device=dev)
    qpad[:, 1 : 1 + Lq] = q.to(torch.int64)
    t64 = t.to(device=dev, dtype=torch.int64)
    tout = None  # the seam above the band: its 2k + 1 top links by column
    sidx = torch.arange(S, device=dev)
    pidx = torch.arange(P, device=dev)[:, None, None]

    def g0(i):  # G at column 0: rows [0, min(q_len, k)] hold D = i
        return torch.where((i <= k) & (i <= ql.view(-1, *[1] * (i.dim() - 1))), 0, INF_G)

    for band in range(int(nb.max()) if P else 0):
        inb = band < nb
        A = band * RB
        used = torch.where(inb, torch.where(band < nb - 1, S, (last - A) // R + 1), 0)
        a0 = A + sidx * R  # [S] the stages' first rows
        ri = a0[:, None] + torch.arange(R, device=dev)  # [S, R]
        jb = max(1, A - k)
        ncols = torch.where(inb, (torch.minimum(n, A + used * R - 1 + k) - jb + 1).clamp(min=0), 0)
        # the seams below and above, columns from A - k - 1 and A + RB - k - 1
        tin, tout = tout, torch.full((P, Bw), INF_G, dtype=torch.int64, device=dev)
        tin0, tout0 = A - k - 1, A + RB - k - 1
        lastin = torch.minimum(n, torch.full_like(n, A - 1 + k))

        def seam(col, tin=tin, tin0=tin0, lastin=lastin):
            """The band below's top link at column col; none past lastin."""
            return torch.where(col > lastin, INF_G, tin[:, min(max(col - tin0, 0), Bw - 1)])

        G = g0(ri[None].expand(P, S, R))
        code = qpad[:, ri.clamp(max=Lq + 1)]  # [P, S, R]
        if band == 0:
            first = torch.full((P,), INF_G, dtype=torch.int64, device=dev)
        elif jb > 1:
            first = seam(jb - 1)
        else:
            first = g0(torch.full((P,), A - 1, device=dev))
        prev = torch.cat([first[:, None], g0((a0[1:] - 1)[None].expand(P, S - 1))], dim=1)
        handed = torch.full((P, S), INF_G, dtype=torch.int64, device=dev)
        live = sidx[None, :] < used[:, None]
        for u in range(int((ncols + used - 1).max()) if int(ncols.max()) else 0):
            c = u - sidx
            j = jb + c  # [S], the same for every pair
            act = live & (c >= 0)[None, :] & (c[None, :] < ncols[:, None])
            l0 = seam(int(j[0])) if band else torch.full((P,), INF_G, device=dev)
            link = torch.cat([l0[:, None], handed[:, :-1]], dim=1)
            tc = t64[:, j.clamp(1, Lt) - 1]
            lo, hi = j - k, j + k
            run = torch.where((a0 - 1 >= lo)[None, :], link, INF_G)  # band 0's stage 0: INF_G
            pv = prev
            new = G.clone()
            for r in range(R):
                i = a0 + r
                old = G[..., r]
                match = ((code[..., r] >> tc) & 1) if use_mask else (code[..., r] == tc).to(torch.int64)
                cand = torch.minimum(old, pv - 1 - match)
                pv = old
                run = torch.where((i > lo)[None, :], torch.minimum(run, cand), cand)
                new[..., r] = torch.where((i <= hi)[None, :], run, old)
            work = act & ~((a0 + R - 1 < lo) | (a0 > hi))[None, :]
            G = torch.where(work[..., None], new, G)
            prev = torch.where(act, link, prev)
            handed = G[..., R - 1]
            w = act[:, S - 1] & (band < nb - 1) & (int(j[S - 1]) >= tout0)
            if bool(w.any()):
                tout[w, int(j[S - 1]) - tout0] = handed[w, S - 1]
        # the captured lanes of this band's rows
        lane = ri[None] - n[:, None, None] + k
        keep = (live[..., None] & (lane >= 0) & (lane < Bw) & (ri[None] <= ql[:, None, None])
                & inb[:, None, None])
        vals = (G + ri[None] + n[:, None, None]).clamp(max=BIG)
        out[pidx.expand_as(lane)[keep], lane[keep]] = vals[keep]
    return out.to(torch.int32)


def _lowbits(n: torch.Tensor) -> torch.Tensor:
    """Per word, the mask of its lowest n bits (n clamped to 0..32)."""
    n = n.clamp(0, 32)
    return torch.where(n >= 32, M32, (torch.ones_like(n) << n.clamp(max=31)) - 1)


def myers_staged(q, q_lens, t, t_lens, k: int, words: int | None = None,
                 stages: int | None = None) -> torch.Tensor:
    """K5 as its wide route computes it, [P, 2k+1] int32, bit-equal to
    banded_final_column_myers on every lane. Offset rows a = i + k (band
    lane b at column j is row j + b) in 32-row words, in stages of `words`
    (default WIDE_R), `stages` a band (default myers_wide_stages'), run as
    K6's pipeline (semi_staged): VP, VN and the Peq words stay in place, a
    stage steps its words with the link of the stage below (the add's carry,
    the HP / HN bits of its top row). The band in offset rows: the add
    starts at cut = max(j, k + 1) with no carry and HP = +1, HN = 0 shifted
    into it (the NW boundary row a = k while j <= k, the band's bottom a = j
    after), and the top a = j + 2k rises a row a column. The virtual rows a
    <= k are held as VP = VN = 0 (no Peq bit), which a step leaves as they
    are and which hand the row above exactly that; their -1 ramp is put
    back at the capture. The row entering the top is set to VP = 1, VN = 0
    (the twin's slid-in top lane); the rows above it are stepped but reach
    nothing below. Only the stage holding the bottom row j > k masks the
    rows below it out of the add. Only rows up to min(q_len + k, t_len + 2k)
    are held, and a stage with no row in [cut, j + 2k] does nothing. The
    anchor, D at band lane 0, is k while j <= k and then follows row j,
    stepped by the stage that holds it (in the kernel handed from stage to
    stage through shared memory). At j = t_len the rows [t_len, t_len + 2k]
    are captured as the twin's planes and the column rebuilt by
    reconstruct_myers_column."""
    from .hw_filter import WIDE_R

    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    WR = words or WIDE_R
    S = stages or myers_wide_stages(Lq, Lt, k)[0]
    Bw = 2 * k + 1
    ql = q_lens.to(device=dev, dtype=torch.int64)
    tl = t_lens.to(device=dev, dtype=torch.int64)
    n = torch.where((tl < 0) | (tl > Lt), -1, tl)
    ok = (n >= 0) & (n <= ql + k)  # else no captured lane is a row of the query
    hi_row = torch.minimum(ql + k, n + 2 * k)
    nst = torch.where(ok, (hi_row // 32) // WR + 1, 0)  # stages a pair holds
    nb = -(-nst // S)
    SR = 32 * WR
    RB = S * SR
    nbw = max(1, int(nb.max()) * S * WR) if P else 1
    peq = peq_bitmaps(q, q_lens, k + 1, nbw)  # [P, 4, words] over offset rows
    capp = torch.zeros((P, Bw), dtype=torch.int64, device=dev)
    capn = torch.zeros_like(capp)
    ca = torch.full((P,), k, dtype=torch.int64, device=dev)
    anchor = ca.clone()
    tops = torch.full((P, Lt + 1), 2, dtype=torch.int64, device=dev)
    t64 = t.to(device=dev, dtype=torch.int64)
    sidx = torch.arange(S, device=dev)
    ridx = torch.arange(WR, device=dev)
    lanes = torch.arange(Bw, device=dev)
    sh32 = torch.arange(32, dtype=torch.int64, device=dev)
    for band in range(int(nb.max()) if P else 0):
        inb = band < nb
        A = band * RB
        used = torch.where(inb, torch.where(band < nb - 1, S, nst - band * S), 0)
        sw = (band * S + sidx) * WR  # [S] the stages' first words
        R0 = 32 * sw
        base = R0[:, None] + 32 * ridx  # [S, WR] the row of each word's bit 0
        aend = A + used * SR - 1
        jb = max(1, A - 2 * k)
        je = torch.where(aend >= k + 1, torch.minimum(n, aend), 0)
        ncols = torch.where(inb, (je - jb + 1).clamp(min=0), 0)
        # column 0: VP = 1 above row 0 (a > k); the virtual rows held as 0
        vp = (_lowbits(k + 1 - base) ^ M32).expand(P, S, WR).clone()
        vn = torch.zeros_like(vp)
        planes = peq[:, :, sw[:, None] + ridx]  # [P, 4, S, WR]
        live = sidx[None, :] < used[:, None]
        handed = torch.full((P, S), 2, dtype=torch.int64, device=dev)
        for u in range(int((ncols + used - 1).max()) if int(ncols.max()) else 0):
            c = u - sidx
            j = jb + c  # [S]
            act = live & (c >= 0)[None, :] & (c[None, :] < ncols[:, None])
            cut = torch.clamp(j, min=k + 1)
            top = j + 2 * k
            if band:  # the band below's top links, where its top row is stepped
                l0 = torch.where(A - 1 >= cut[0], tops[:, min(int(j[0]), Lt)], 2)
            else:
                l0 = torch.full((P,), 2, dtype=torch.int64, device=dev)
            link = torch.cat([l0[:, None], handed[:, :-1]], dim=1)
            tc = t64[:, j.clamp(1, Lt) - 1]
            eq = torch.zeros_like(vp)
            for code in range(4):
                eq = torch.where((tc == code)[..., None], planes[:, code], eq)
            d = top[:, None] - base  # the row entering the top, as a bit of each word
            enter = torch.where((d >= 0) & (d < 32), 1 << d.clamp(0, 31), 0)
            vp0 = vp | enter  # the values the step reads
            vn0 = vn & (enter ^ M32)
            # the stage of the bottom row j > k keeps the rows below it out of the add
            keep = _lowbits(torch.where(j > k, j - R0, 0)[:, None] - 32 * ridx) ^ M32
            mvp, mvn = vp0 & keep, vn0 & keep
            x = (eq & keep) | mvn
            carry = link & 1
            hpp, hnp = (link >> 1) & 1, (link >> 2) & 1
            nvp, nvn, hpw, hnw = [], [], [], []
            for r in range(WR):
                full = (x[..., r] & mvp[..., r]) + mvp[..., r] + carry
                carry, sm = full >> 32, full & M32
                d0 = (sm ^ mvp[..., r]) | x[..., r]
                hp = mvn[..., r] | ((d0 | mvp[..., r]) ^ M32)
                hn = d0 & mvp[..., r]
                hpsh = ((hp << 1) & M32) | hpp
                hnsh = ((hn << 1) & M32) | hnp
                nvp.append((hnsh | ((d0 | hpsh) ^ M32)) & M32)
                nvn.append(d0 & hpsh)
                hpw.append(hp)
                hnw.append(hn)
                hpp, hnp = hp >> 31, hn >> 31
            out = carry | (hpp << 1) | (hnp << 2)
            work = act & ~((R0 + SR - 1 < cut) | (R0 > top))[None, :]
            # the anchor: row j's vertical delta at column j - 1 (none when
            # k = 0: the twin's lane 1 is past the band) and its HP - HN
            hold = work & ((j > k) & (R0 <= j) & (j < R0 + SR))[None, :]
            off = (j - R0).clamp(0, SR - 1)
            hr, hb = off // 32, off % 32
            s_i = sidx[None, :].expand(P, S)

            def bit(v, hr=hr, hb=hb):
                return (v[torch.arange(P, device=dev)[:, None], s_i, hr[None, :].expand(P, S)]
                        >> hb[None, :]) & 1

            d_old = (bit(vp0) - bit(vn0)) if k > 0 else 0
            h = bit(torch.stack(hpw, dim=-1)) - bit(torch.stack(hnw, dim=-1))
            anchor = anchor + torch.where(hold, d_old + h, 0).sum(dim=1)
            at_n = (hold & (j[None, :] == n[:, None])).any(dim=1)
            ca = torch.where(at_n, anchor, ca)
            vp = torch.where(work[..., None], torch.stack(nvp, dim=-1), vp)
            vn = torch.where(work[..., None], torch.stack(nvn, dim=-1), vn)
            handed = torch.where(work, out, 2)
            w = act[:, S - 1] & (band < nb - 1)
            if bool(w.any()):
                tops[w, int(j[S - 1])] = handed[w, S - 1]
        # capture: lane b <- offset row t_len + b, where this band holds it
        bits_p = ((vp[..., None] >> sh32) & 1).reshape(P, S * SR)
        bits_n = ((vn[..., None] >> sh32) & 1).reshape(P, S * SR)
        row = n[:, None] + lanes[None, :] - A  # [P, Bw] index into the band's rows
        held = inb[:, None] & ok[:, None] & (row >= 0) & (row < used[:, None] * SR)
        rc = row.clamp(0, S * SR - 1)
        capp = torch.where(held, bits_p.gather(1, rc), capp)
        capn = torch.where(held, bits_n.gather(1, rc), capn)
    # the virtual rows' -1 ramp, rows 1 .. k
    row = n[:, None] + lanes[None, :]
    capn = torch.where(ok[:, None] & (row >= 1) & (row <= k), 1, capn)
    return reconstruct_myers_column(pack_bits(capp), pack_bits(capn), ca, q_lens, t_lens, k)
