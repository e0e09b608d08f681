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
# serves. Tests and chip_smoke patch it down to force K5 on small cases.
MYERS_MIN_K = 256

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
