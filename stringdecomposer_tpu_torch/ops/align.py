"""General batched sequence alignment (edlib's API: modes NW/SHW/HW x tasks
distance/locations/path, the k threshold, standard and extended CIGAR,
additionalEqualities), ported from stringdecomposer_tpu/ops/align.py.

Semantics are the JAX package's, which are pinned to the reference edlib by
the fixtures in tests/fixtures/ (reference src/edlib.h:36-71):

  - mode NW: global; endLocations = [|t|-1] (src/edlib.cpp:215-219).
  - mode SHW: target suffix free; all optimal end locations, ascending.
  - mode HW: target prefix+suffix free; per-end start location = the
    SMALLEST start achieving the optimum, via edlib's reversed-SHW rule
    "taking last location as start" (src/edlib.cpp:226-258).
  - task path: alignment/CIGAR for the FIRST (start, end) pair only, with
    the traceback's local preference up > left > diagonal
    (src/edlib.cpp:1023-1088) reproduced by forward move recording.
  - memory-bounded path: pairs whose move table would exceed the
    reference's bound take Hirschberg divide-and-conquer (_hirschberg_ops,
    src/edlib.cpp:1188-1400), batched per recursion level.

The DP scans below are the JAX package's lax.scan primitives as Python loops
over target columns, each column a [P, width] tensor op on the tensors'
device. The banded final-column sweep and the semi-global end-row scan have
hand-written CUDA kernels (ops/banded_cuda.py: K4, K5, K6); the routers
(_banded_final_column, _banded_nw_dist, _banded_shw_rows_routed,
_semi_rows_routed) pick them per ops/banded.DEFAULT_BACKEND. Host arrays are
NumPy; each router moves its inputs to `device` and its result back, with
the batch's pairs split over the devices of `device`'s type
(_rows_sharded, SDTPU_ALIGN_DP).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

BIG = 1 << 28

# edlib edit-op codes (src/edlib.h:84-87); I consumes query, D consumes target
EDOP_MATCH, EDOP_INSERT, EDOP_DELETE, EDOP_MISMATCH = 0, 1, 2, 3
_EXT_CHAR = {EDOP_MATCH: "=", EDOP_INSERT: "I", EDOP_DELETE: "D", EDOP_MISMATCH: "X"}
_STD_CHAR = {EDOP_MATCH: "M", EDOP_INSERT: "I", EDOP_DELETE: "D", EDOP_MISMATCH: "M"}


def _encode_any(seq) -> np.ndarray:
    """Arbitrary byte alphabet -> uint8 codes (edlib supports any chars,
    src/edlib.cpp:1420-1459; equality is all the DP ever needs)."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8)
    if isinstance(seq, bytes):
        return np.frombuffer(seq, dtype=np.uint8)
    return np.frombuffer(str(seq).encode(), dtype=np.uint8)


@dataclass
class _EqEncoding:
    """Role-specific transforms implementing the additionalEqualities
    relation (src/edlib.h:133-149; symmetric like the reference's
    equalityDefinitions matrix, src/edlib.cpp:1429-1437).

    mode="mask" (<=32 distinct symbols): q_lut maps a byte to an int32
    bitmask over the compact alphabet, t_lut to a compact id, and equality
    is `(qmask >> id) & 1`. mode="lut" (up to 256 symbols): q_lut maps to
    `id * stride`, t_lut to `id`, and equality is the gather
    `eq_flat[q + t]`. Compact id 0 is reserved for padding/boundaries (row
    and column 0 of eq_flat are zeros, so pads never match anything)."""

    mode: str
    q_lut: np.ndarray  # [256] int32
    t_lut: np.ndarray  # [256] int32
    eq_flat: np.ndarray | None  # [stride*stride] int32 ("lut" mode only)


def _equality_encoding(codes_list: list[np.ndarray], pairs) -> _EqEncoding:
    present = np.zeros(256, dtype=bool)
    for c in codes_list:
        present[np.unique(c)] = True
    symbols = np.flatnonzero(present)
    A = len(symbols)
    eq = np.zeros((256, 256), dtype=bool)
    eq[symbols, symbols] = True
    for a, b in pairs:
        ca = ord(a) if isinstance(a, str) else int(a)
        cb = ord(b) if isinstance(b, str) else int(b)
        eq[ca, cb] = eq[cb, ca] = True
    if A <= 32:
        ids = np.full(256, 0, dtype=np.int32)
        ids[symbols] = np.arange(A, dtype=np.int32)
        # built in int64 and reinterpreted: a mask using bit 31 (exactly 32
        # symbols) overflows a direct int32 assignment
        mask64 = np.zeros(256, dtype=np.int64)
        for b in symbols:
            mask64[b] = sum(1 << int(ids[s]) for s in symbols if eq[b, s])
        return _EqEncoding("mask", mask64.astype(np.uint32).view(np.int32), ids, None)
    # big-alphabet route: ids 1..A (0 = pad sentinel), flat equality table
    stride = A + 1
    ids = np.zeros(256, dtype=np.int32)
    ids[symbols] = np.arange(1, A + 1, dtype=np.int32)
    eq_flat = np.zeros(stride * stride, dtype=np.int32)
    for a in symbols:
        row = ids[a] * stride
        for b in symbols:
            if eq[a, b]:
                eq_flat[row + ids[b]] = 1
    return _EqEncoding("lut", ids * stride, ids, eq_flat)


# ---------------------------------------------------------------------------
# DP scans (plain PyTorch; run on the device of their inputs)
# ---------------------------------------------------------------------------
def _sub_fn(qcol, tchar, use_mask, eq_flat=None):
    """Substitution cost row: 0 where query/target chars are "equal".

    use_mask=False: qcol holds raw codes, plain equality. use_mask=True:
    qcol holds per-position int32 bitmasks over a compact alphabet and
    tchar compact symbol ids, equality is ((qmask >> id) & 1) (an
    arithmetic shift, bit 31 included). With eq_flat (lut mode): qcol holds
    id*stride, tchar ids, equality is one gather."""
    if eq_flat is not None:
        return 1 - eq_flat[(qcol + tchar[:, None]).long()]
    if use_mask:
        return 1 - ((qcol >> tchar[:, None]) & 1)
    return (qcol != tchar[:, None]).to(torch.int32)


def _prep(q, t, eq_flat):
    q = q.to(torch.int32)
    t = t.to(torch.int32)
    if eq_flat is not None:
        eq_flat = eq_flat.to(device=q.device, dtype=torch.int32)
    return q, t, eq_flat


def _full_col(P, value, dev):
    return torch.full((P, 1), value, dtype=torch.int32, device=dev)


def dp_lastrow_batch(q, q_lens, t, t_lens, free_target_prefix=False, use_mask=False,
                     eq_flat=None):
    """Last DP row per pair: out[p, j] = dist(q[p][:q_len], t[p][:j]) for
    j = 0..Lt, [P, Lt+1] int32 (entries past t_len are garbage; callers
    mask). `free_target_prefix` is HW's boundary D[0][j] = 0. Lengths must
    lie within the padded widths."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    q, t, eq_flat = _prep(q, t, eq_flat)
    i_idx = torch.arange(Lq + 1, dtype=torch.int32, device=dev)
    qcol = torch.cat([_full_col(P, 0 if use_mask else -1, dev), q], dim=1)
    end = q_lens.to(device=dev, dtype=torch.int64)[:, None]
    big = _full_col(P, BIG, dev)
    C = i_idx.expand(P, Lq + 1)
    rows = [C.gather(1, end)[:, 0]]
    for j in range(1, Lt + 1):
        sub = _sub_fn(qcol, t[:, j - 1], use_mask, eq_flat)
        cand = torch.minimum(C + 1, torch.cat([big, C[:, :-1]], dim=1) + sub)
        cand[:, 0] = 0 if free_target_prefix else j
        C = torch.cummin(cand - i_idx, dim=1).values + i_idx
        rows.append(C.gather(1, end)[:, 0])
    return torch.stack(rows, dim=1)


def _banded_columns(q, q_lens, t, k, use_mask, eq_flat, n_cols):
    """The Ukkonen band carried over target columns 1..n_cols (the shared
    recurrence of the three banded scans): lane b of the band holds row
    i = j + b - k at column j. Yields (j, i_here [1, Bw], D [P, Bw]) per
    column, after (0, i_here, D0) for column 0. The query under the band is
    a plain slice of q padded by k+1 junk codes in front and enough behind,
    so no slice ever reaches past the array."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    Bw = 2 * k + 1
    b_idx = torch.arange(Bw, dtype=torch.int32, device=dev)[None, :]
    pad_code = 0 if use_mask else -1
    qp = torch.full((P, Lq + 2 * k + 2 + max(0, Lt - Lq)), pad_code, dtype=torch.int32,
                    device=dev)
    qp[:, k + 1 : k + 1 + Lq] = q
    ql = q_lens.to(device=dev, dtype=torch.int32)[:, None]
    i0 = b_idx - k
    D = torch.where((i0 >= 0) & (i0 <= ql), i0, BIG).expand(P, Bw)
    yield 0, i0, D
    big = _full_col(P, BIG, dev)
    for j in range(1, n_cols + 1):
        i_here = j + b_idx - k
        sub = _sub_fn(qp[:, j : j + Bw], t[:, j - 1], use_mask, eq_flat)
        left = torch.cat([D[:, 1:], big], dim=1) + 1
        cand = torch.minimum(left, D + sub)
        cand = torch.where(i_here == 0, j, cand)  # boundary row 0 enters while j <= k
        valid = (i_here >= 0) & (i_here <= ql)
        cand = torch.where(valid, cand, BIG)
        # up-chain: D[b] = min(cand[b], D[b-1] + 1) along lanes
        D = torch.where(valid, torch.cummin(cand - b_idx, dim=1).values + b_idx, BIG)
        yield j, i_here, D


def dp_banded_nw_batch(q, q_lens, t, t_lens, k, use_mask=False, eq_flat=None):
    """Banded NW distance (the Ukkonen band, src/edlib.cpp:559-571): only the
    2k+1 diagonals |i-j| <= k are computed. Returns dist[P], exact wherever
    the true distance is <= k. Pairs with |q_len - t_len| > k are
    unreachable and must be pre-filtered by the caller."""
    q, t, eq_flat = _prep(q, t, eq_flat)
    dev = q.device
    ql = q_lens.to(device=dev, dtype=torch.int32)
    tl = t_lens.to(device=dev, dtype=torch.int32)
    dist = torch.zeros(q.shape[0], dtype=torch.int32, device=dev)
    for j, i_here, D in _banded_columns(q, q_lens, t, k, use_mask, eq_flat, t.shape[1]):
        if j:  # capture at (q_len, t_len): lane q_len - j + k when j == t_len
            hit = (j == tl)[:, None] & (i_here == ql[:, None])
            dist = dist + torch.where(hit, D, 0).sum(dim=1, dtype=torch.int32)
    return torch.where(tl == 0, ql, dist)


def dp_banded_lastrow_batch(q, q_lens, t, t_lens, k, use_mask=False, eq_flat=None):
    """Banded NW final COLUMN: out[p, b] = dist(q[p][:i], t[p][:t_len]) for
    row i = t_len + b - k, b in [0, 2k], BIG for rows outside [0, q_len] or
    values whose optimal path leaves the band (any value <= k is exact).
    [P, 2k+1] int32. This is K4's plain twin (ops/banded_cuda.py), and the
    Hirschberg sweep primitive."""
    q, t, eq_flat = _prep(q, t, eq_flat)
    tl = t_lens.to(device=q.device, dtype=torch.int64)[:, None]
    n_cols = min(t.shape[1], int(tl.max())) if tl.numel() else 0
    cap = None
    for j, _, D in _banded_columns(q, q_lens, t, k, use_mask, eq_flat, n_cols):
        cap = torch.where(tl == 0, D, BIG) if j == 0 else torch.where(tl == j, D, cap)
    return torch.minimum(cap, torch.tensor(BIG, dtype=torch.int32, device=q.device))


def dp_banded_shw_rows(q, q_lens, t, t_lens, k, use_mask=False, eq_flat=None):
    """Banded SHW scan: out[p, j-1] = dist(q[p][:q_len], t[p][:j]) for target
    columns j in 1..Lt wherever row q_len is inside the band (|q_len - j| <=
    k), BIG elsewhere and past t_len. [P, Lt] int32."""
    q, t, eq_flat = _prep(q, t, eq_flat)
    dev = q.device
    P, Lt = t.shape
    ql = q_lens.to(device=dev, dtype=torch.int32)[:, None]
    tl = t_lens.to(device=dev, dtype=torch.int32)
    out = torch.full((P, Lt), BIG, dtype=torch.int32, device=dev)
    n_cols = min(Lt, int(tl.max())) if P else 0
    for j, i_here, D in _banded_columns(q, q_lens, t, k, use_mask, eq_flat, n_cols):
        if j:
            hit = (i_here == ql) & (j <= tl)[:, None]
            out[:, j - 1] = torch.where(hit, D, BIG).min(dim=1).values
    return out


def dp_hw_chunk_batch(q, q_lens, c_in, t, t_lens, wm_thr, use_mask=False, eq_flat=None):
    """One target chunk of the adaptive-row HW scan (the reference's banded
    semi-global pass, src/edlib.cpp:547-728, with rows pruned per chunk).

    HW recurrence over live rows 0..R (row 0 free: a new start at every
    column). Returns (c_out [P, R+1], ends [P, Wc] = row-q_len value per
    column or BIG when q_len > R, wm [P] = highest row with value <= wm_thr
    after the chunk). Columns at or past t_len freeze the column."""
    P, R = q.shape
    Wc = t.shape[1]
    dev = q.device
    q, t, eq_flat = _prep(q, t, eq_flat)
    i_idx = torch.arange(R + 1, dtype=torch.int32, device=dev)
    qcol = torch.cat([_full_col(P, 0 if use_mask else -1, dev), q], dim=1)
    ql = q_lens.to(device=dev, dtype=torch.int32)
    tl = t_lens.to(device=dev, dtype=torch.int32)
    row_valid = i_idx[None, :] <= ql[:, None]
    endmask = i_idx[None, :] == ql[:, None]
    big = _full_col(P, BIG, dev)
    C = c_in.to(device=dev, dtype=torch.int32)
    ends = []
    for j in range(Wc):
        sub = _sub_fn(qcol, t[:, j], use_mask, eq_flat)
        cand = torch.minimum(C + 1, torch.cat([big, C[:, :-1]], dim=1) + sub)
        cand[:, 0] = 0  # free start (HW prefix)
        Cn = torch.cummin(cand - i_idx, dim=1).values + i_idx
        Cn = torch.where(row_valid, Cn, BIG)
        live = (j < tl)[:, None]
        C = torch.where(live, Cn, C)  # past t_len: freeze
        endv = torch.where(endmask & live, C, 0).sum(dim=1, dtype=torch.int32)
        ends.append(torch.where((ql <= R) & (j < tl), endv, BIG))
    live_rows = (C <= int(wm_thr)) & row_valid
    wm = torch.where(live_rows, i_idx, -1).max(dim=1).values
    return C, torch.stack(ends, dim=1), wm


def dp_moves_batch(q, q_lens, t, t_lens, use_mask=False, eq_flat=None):
    """Global-NW move matrix for the PATH task.

    Returns (dist[P] int32, moves[P, Lt+1, Lq+1] uint8) where moves[p, j, i]
    is the traceback step at cell (i, j) under edlib's preference order
    up > left > diag (src/edlib.cpp:1023-1088): EDOP_INSERT consumes a query
    char (up), EDOP_DELETE a target char (left), MATCH/MISMATCH both.
    Boundary rows/columns are handled by the host walker."""
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    q, t, eq_flat = _prep(q, t, eq_flat)
    i_idx = torch.arange(Lq + 1, dtype=torch.int32, device=dev)
    qcol = torch.cat([_full_col(P, 0 if use_mask else -1, dev), q], dim=1)
    end = q_lens.to(device=dev, dtype=torch.int64)[:, None]
    big = _full_col(P, BIG, dev)
    C = i_idx.expand(P, Lq + 1)
    rows = [C.gather(1, end)[:, 0]]
    moves = torch.empty((P, Lt + 1, Lq + 1), dtype=torch.uint8, device=dev)
    moves[:, 0] = EDOP_INSERT  # column j = 0: up
    for j in range(1, Lt + 1):
        sub = _sub_fn(qcol, t[:, j - 1], use_mask, eq_flat)
        left = C + 1
        cand = torch.minimum(left, torch.cat([big, C[:, :-1]], dim=1) + sub)
        cand[:, 0] = j
        Cn = torch.cummin(cand - i_idx, dim=1).values + i_idx
        up = torch.cat([big, Cn[:, :-1]], dim=1) + 1
        mv = torch.where(sub == 0, EDOP_MATCH, EDOP_MISMATCH)
        mv = torch.where(left == Cn, EDOP_DELETE, mv)
        moves[:, j] = torch.where(up == Cn, EDOP_INSERT, mv).to(torch.uint8)
        rows.append(Cn.gather(1, end)[:, 0])
        C = Cn
    allrows = torch.stack(rows, dim=1)
    dist = allrows.gather(1, t_lens.to(device=dev, dtype=torch.int64)[:, None])[:, 0]
    return dist, moves


# ---------------------------------------------------------------------------
# Routers: the kernels of ops/banded_cuda.py or the scans above
# ---------------------------------------------------------------------------
def _on(device, *arrays):
    """NumPy arrays -> int32 tensors on `device`."""
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)
            for a in arrays]


def _eq_on(device, eq_flat):
    return None if eq_flat is None else _on(device, eq_flat)[0]


# data-parallel alignment batches: "auto" splits the pair axis of every
# routed sweep over the devices of the call's device type (every visible GPU
# for "cuda"; rows are independent pairs, so no collective); "off" keeps
# one device. Read once at import.
ALIGN_DATA_PARALLEL = os.environ.get("SDTPU_ALIGN_DP", "auto")
# the devices _rows_sharded splits over in place of the call device's
# (None: those); a repeated list runs several shards on one device, as the
# tests and chip_smoke.py do to show that the bytes do not depend on it
ROW_DEVICES: list | None = None


def _row_devices(device) -> list[torch.device]:
    if ROW_DEVICES is not None:
        return [torch.device(d) for d in ROW_DEVICES]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _rows_sharded(fn, arrays, eq_flat=None, *, device):
    """fn(*arrays[, eq_flat=]) with the leading axis of the NumPy `arrays`
    split over the devices (_row_devices), the equality table copied to
    each: bit-identical to one call, since each row is an independent pair
    and the rows come back in order. `fn` takes int32 tensors on one device
    and returns a tensor or a tuple of tensors led by the rows; the result
    is NumPy. Every shard is launched
    before any is read back, so the devices run at once. Falls through to
    one call on `device` with one device, fewer rows than devices, or
    SDTPU_ALIGN_DP=off."""
    from ..parallel.sharding import device_guard

    devs = _row_devices(device)
    n_dev = len(devs)
    P0 = arrays[0].shape[0]

    def call(d, parts):
        eq = {} if eq_flat is None else {"eq_flat": _eq_on(d, eq_flat)}
        return fn(*_on(d, *parts), **eq)

    def host(out):
        return out.cpu().numpy()

    if ALIGN_DATA_PARALLEL == "off" or n_dev == 1 or P0 < n_dev:
        out = call(device, arrays)
        return tuple(map(host, out)) if isinstance(out, tuple) else host(out)
    S = -(-P0 // n_dev)
    padded = [np.pad(np.asarray(a), [(0, S * n_dev - P0)] + [(0, 0)] * (np.ndim(a) - 1))
              for a in arrays]
    outs = []
    for i, d in enumerate(devs):
        with device_guard(d):
            outs.append(call(d, [a[i * S : (i + 1) * S] for a in padded]))
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([host(o[k]) for o in outs])[:P0]
                     for k in range(len(outs[0])))
    return np.concatenate([host(o) for o in outs])[:P0]


def _kernel_routes(device) -> bool:
    """Whether the routers take the K4/K5/K6 routes: ops/banded's
    DEFAULT_BACKEND "kernel" always (on CPU tensors the wrappers run their
    twins), "auto" on CUDA, "scan" never."""
    from . import banded

    mode = banded.DEFAULT_BACKEND
    return mode == "kernel" or (mode == "auto" and torch.device(device).type == "cuda")


def _banded_final_column(q, ql, t, tl, k, use_mask=False, eq_flat=None, *, device):
    """Route one banded final-column sweep: the bit-parallel Myers kernel K5
    for wide bands on <= 4-symbol inputs, the int32 band kernel K4 otherwise,
    or the dp_banded_lastrow_batch scan. Every route is exact wherever the
    value is <= k, the only values any caller observes (Ukkonen); K5 may
    differ from the others on > k lanes. Returns [P, 2k+1] NumPy."""
    from . import banded, banded_cuda

    enabled = _kernel_routes(device)
    if enabled and banded.myers_supported(t.shape[1], int(k), eq_flat, use_mask):
        remap = _myers_compact_alphabet(q, ql, t, tl)
        if remap is not None:
            return _rows_sharded(partial(banded_cuda.banded_myers_cuda, k=int(k)),
                                 (remap[0], ql, remap[1], tl), device=device)
    if enabled and banded.supported(q.shape[0], q.shape[1], t.shape[1], int(k), eq_flat):
        return _rows_sharded(
            partial(banded_cuda.banded_final_column_cuda, k=int(k), use_mask=use_mask),
            (q, ql, t, tl), device=device)
    return _rows_sharded(partial(dp_banded_lastrow_batch, k=int(k), use_mask=use_mask),
                         (q, ql, t, tl), eq_flat, device=device)


# minimum padded length before exact NW distance (k=-1) switches from the
# one full sweep to banded k-doubling
NW_DOUBLING_MIN_LEN = 4096


def _rows_pow2(arr, lens, idx):
    """Row-subset arr[idx] padded to a pow2 row count (length-0 filler rows),
    as the JAX package batches the doubling loop's shrinking subsets."""
    m = 1 << max(0, int(np.ceil(np.log2(max(1, len(idx))))))
    out = np.zeros((m, arr.shape[1]), arr.dtype)
    out[: len(idx)] = arr[idx]
    lo = np.zeros(m, np.int32)
    lo[: len(idx)] = lens[idx]
    return out, lo


def _myers_compact_alphabet(q, ql, t, tl):
    """Remap raw byte codes to the <=4-symbol compact alphabet the Myers
    kernels' Peq planes cover, or None if the inputs need more. Only symbols
    present in BOTH valid regions can produce a match, so q-only / t-only
    symbols map to distinct never-equal sentinels."""
    qn = np.asarray(q).astype(np.uint8)  # plain-code route: byte alphabet
    tn = np.asarray(t).astype(np.uint8)
    qmask = np.arange(qn.shape[1])[None, :] < np.asarray(ql)[:, None]
    tmask = np.arange(tn.shape[1])[None, :] < np.asarray(tl)[:, None]
    syms = np.intersect1d(np.unique(qn[qmask]), np.unique(tn[tmask]))
    if len(syms) > 4:
        return None
    lut_q = np.full(256, -9, np.int32)
    lut_t = np.full(256, -1, np.int32)
    lut_q[syms] = np.arange(len(syms))
    lut_t[syms] = np.arange(len(syms))
    return lut_q[qn], lut_t[tn]


def _lastrow(q, ql, t, tl, free_target_prefix=False, use_mask=False, eq_flat=None, *, device):
    """dp_lastrow_batch with the pairs split over the devices, NumPy in and out."""
    return _rows_sharded(
        partial(dp_lastrow_batch, free_target_prefix=free_target_prefix, use_mask=use_mask),
        (q, ql, t, tl), eq_flat, device=device)


def _banded_shw_rows_routed(q, ql, t, tl, k, Ltc, use_mask, eq_flat, *, device):
    """Banded SHW rows [P, Ltc], routed: on the kernel routes the row values
    come from the TRANSPOSED banded-NW final column: dist(q[:ql], t[:j]) =
    dist(t[:j], q[:ql]), and the |i-j| <= k band is transpose-symmetric, so
    the final column of the swapped problem at target column ql is exactly
    the row-q_len value at every in-band j in [ql-k, ql+k]. The
    dp_banded_shw_rows scan otherwise."""
    from . import banded

    eligible = _kernel_routes(device) and not use_mask and eq_flat is None and (
        banded.myers_supported(q.shape[1], int(k), eq_flat, use_mask)
        or banded.supported(q.shape[0], Ltc, q.shape[1], int(k), eq_flat)
    )
    t_cut = np.ascontiguousarray(np.asarray(t)[:, :Ltc])
    if not eligible:
        return _rows_sharded(partial(dp_banded_shw_rows, k=int(k), use_mask=use_mask),
                             (q, ql, t_cut, tl), eq_flat, device=device)
    q2l = np.minimum(np.asarray(tl), Ltc).astype(np.int32)
    cap = _banded_final_column(t_cut, q2l, np.asarray(q), np.asarray(ql).astype(np.int32),
                               k=int(k), device=device)
    P, Bw = q.shape[0], 2 * int(k) + 1
    rows = np.full((P, Ltc), BIG, np.int64)
    b_idx = np.arange(Bw)
    for p in range(P):
        js = int(ql[p]) + b_idx - int(k)
        m = (js >= 1) & (js <= min(Ltc, int(tl[p])))
        rows[p, js[m] - 1] = cap[p, m]
    return rows


def _semi_rows_routed(q, ql, t, tl, free_target_prefix, use_mask, eq_flat, *, device):
    """Row-q_len values for target columns 1..Lt ([P, Lt], EXACT) from the
    full-height semi-global Myers kernel K6: one launch for the whole
    target. None when the route is unavailable (the caller scans)."""
    from . import banded, banded_cuda

    if not (_kernel_routes(device)
            and banded.semi_supported(q.shape[0], q.shape[1], eq_flat, use_mask)):
        return None
    remap = _myers_compact_alphabet(q, ql, t, tl)
    if remap is None:
        return None
    ends = _rows_sharded(partial(banded_cuda.semi_ends_cuda, free_target_prefix=free_target_prefix),
                         (remap[0], ql, remap[1], tl), device=device).astype(np.int64)
    if not free_target_prefix:
        # SHW with an empty query: D(0, j) = j (the kernel's end-row
        # tracking starts at row 0 whose boundary it does not model)
        for p in np.flatnonzero(np.asarray(ql) == 0):
            ends[p] = np.arange(1, ends.shape[1] + 1)
    return ends


def _banded_nw_dist(q, ql, t, tl, k, use_mask=False, eq_flat=None, *, device):
    """Banded NW distance via the routed final-column sweep (the single
    distance is lane q_len - t_len + k of the final target column); on the
    scan route this is dp_banded_nw_batch. Callers pre-filter pairs with
    |q_len - t_len| > k, and trust only results <= k (exact on every
    route). Returns dist[P] NumPy."""
    from . import banded

    if not (_kernel_routes(device) and (
        banded.myers_supported(t.shape[1], int(k), eq_flat, use_mask)
        or banded.supported(q.shape[0], q.shape[1], t.shape[1], int(k), eq_flat)
    )):
        return _rows_sharded(partial(dp_banded_nw_batch, k=int(k), use_mask=use_mask),
                             (q, ql, t, tl), eq_flat, device=device)
    cap = _banded_final_column(q, ql, t, tl, k=int(k), use_mask=use_mask, eq_flat=eq_flat,
                               device=device)
    ql_np = np.asarray(ql, dtype=np.int64)
    tl_np = np.asarray(tl, dtype=np.int64)
    lanes = np.clip(ql_np - tl_np + int(k), 0, 2 * int(k))
    dist = cap[np.arange(cap.shape[0]), lanes]
    return np.where(tl_np == 0, ql_np, dist)


def _hw_banded_scan(q, ql, t, tl, k, use_mask, eq_flat, Wc=256, *, device):
    """Adaptive-row HW scan over column chunks: returns [P, Lt] row-q_len
    values (BIG where provably > k). The host decides each chunk's live
    height R from the previous chunk's watermark wm = highest row with value
    <= k: a cell in the next chunk with value <= k climbs at most Wc rows
    diagonally plus k by insertions above a carried live row (or a fresh
    row-0 start), so R = wm + Wc + k + 1 covers every observable cell
    (src/edlib.cpp:547-728's pruning at chunk granularity)."""
    P, Lq = q.shape
    Lt = t.shape[1]
    out = np.full((P, Lt), BIG, dtype=np.int64)
    ql_np = np.asarray(ql)
    # column 0: C(i, 0) = i (free start at row 0 only helps later columns)
    wm = np.minimum(np.asarray(ql, dtype=np.int64), k)
    C_cur = None
    R_prev = 0
    for j0 in range(0, Lt, Wc):
        if not np.any(j0 < np.asarray(tl)):
            break
        need = int(wm.max()) + Wc + k + 1
        R = min(Lq, 1 << int(np.ceil(np.log2(max(8, need)))))
        c_in = np.full((P, R + 1), BIG, dtype=np.int32)
        if C_cur is None:
            base = np.arange(R + 1, dtype=np.int32)[None, :]
            c_in = np.where(base <= ql_np[:, None], base, BIG).astype(np.int32)
        else:
            keep = min(R_prev, R) + 1
            c_in[:, :keep] = C_cur[:, :keep]
        tl_chunk = np.clip(np.asarray(tl) - j0, 0, Wc).astype(np.int32)
        # R is the whole batch's, so each pair's chunk is the same at any split
        C_cur, ends, wm_d = _rows_sharded(
            partial(dp_hw_chunk_batch, wm_thr=k, use_mask=use_mask),
            (q[:, :R], np.minimum(ql_np, R), c_in, t[:, j0 : j0 + Wc], tl_chunk), eq_flat,
            device=device)
        w = min(Wc, Lt - j0)
        # rows past R are pruned (> k): their end values must not leak
        out[:, j0 : j0 + w] = np.where(ql_np[:, None] <= R, ends[:, :w], BIG)
        wm = np.maximum(wm_d.astype(np.int64), 0)
        R_prev = R
    return out


# ---------------------------------------------------------------------------
# Host assembly
# ---------------------------------------------------------------------------
def _pad_batch(codes: list[np.ndarray], mult: int = 16) -> tuple[np.ndarray, np.ndarray]:
    n = len(codes)
    L = max(1, max((len(c) for c in codes), default=1))
    L = (L + mult - 1) // mult * mult
    dtype = codes[0].dtype if codes else np.uint8
    arr = np.zeros((n, L), dtype=dtype)
    lens = np.zeros(n, dtype=np.int32)
    for i, c in enumerate(codes):
        arr[i, : len(c)] = c
        lens[i] = len(c)
    return arr, lens


def _moves_to_ops(moves: np.ndarray, qlen: int, tlen: int) -> list[int]:
    """Walk moves[j, i] back from (qlen, tlen) to the edit-op list."""
    i, j = qlen, tlen
    ops: list[int] = []
    while i > 0 or j > 0:
        if i == 0:
            mv = EDOP_DELETE
        elif j == 0:
            mv = EDOP_INSERT
        else:
            mv = int(moves[j, i])
        ops.append(mv)
        if mv == EDOP_INSERT:
            i -= 1
        elif mv == EDOP_DELETE:
            j -= 1
        else:
            i -= 1
            j -= 1
    ops.reverse()
    return ops


def _ops_to_cigar(ops: list[int], extended: bool) -> str:
    """Run-length encode an edit-op list into a CIGAR string
    (query-perspective; src/edlib.cpp:298-347)."""
    chars = _EXT_CHAR if extended else _STD_CHAR
    out: list[str] = []
    pos = 0
    n = len(ops)
    while pos < n:
        c = chars[ops[pos]]
        run = pos
        while run < n and chars[ops[run]] == c:
            run += 1
        out.append(f"{run - pos}{c}")
        pos = run
    return "".join(out)


def _moves_to_cigar(moves: np.ndarray, qlen: int, tlen: int, extended: bool) -> str:
    return _ops_to_cigar(_moves_to_ops(moves, qlen, tlen), extended)


# ---------------------------------------------------------------------------
# Memory-bounded PATH: Hirschberg divide & conquer
# ---------------------------------------------------------------------------
# Mirrors the reference's algorithm switch (src/edlib.cpp:1188-1213): pairs
# whose move matrix would exceed MOVES_CELL_LIMIT cells take the divide-and-
# conquer route in O(Lq+Lt) memory. Hirschberg splits are resolved with the
# reference's split-row scan order, the base cases reuse the canonical
# up>left>diag move recorder, and the reported cost always equals the exact
# edit distance.
MOVES_CELL_LIMIT = 1 << 22  # ~4 MB of move codes per pair
# one dp_moves_batch call materializes [n, maxLt+1, maxLq+1] uint8 cells: the
# batched PATH route and the Hirschberg base cases cap aggregate cells per
# call too
MOVES_BATCH_CELL_BUDGET = 1 << 26  # ~64 MB of move codes per device call

# The reference's Hirschberg engage rule (src/edlib.cpp:1190-1213): switch to
# the memory-bounded route when the traceback data would exceed 1 MB, sized as
# (2*sizeof(Word) + sizeof(int)) * ceil(Lq/64) * Lt + 2*sizeof(int) * Lt.
# The two routes return different co-optimal paths, so route choice is
# output-visible. Tests shrink this module global to force engagement.
HB_MEM_BOUND = 1 << 20


def _hb_engages(lq: int, lt: int) -> bool:
    """True when the reference would take the Hirschberg route
    (src/edlib.cpp:1190-1193, Word = 8 bytes, int = 4 bytes)."""
    return (2 * 8 + 4) * (-(-lq // 64)) * lt + 2 * 4 * lt >= HB_MEM_BOUND


def _hirschberg_ops(q: np.ndarray, t: np.ndarray, cell_limit: int | None = None,
                    enc: _EqEncoding | None = None, dist: int | None = None, *,
                    device) -> list[int]:
    """Edit-op list of an optimal NW alignment of (q, t) without ever
    materializing an O(Lq*Lt) table; the recursion runs level by level so
    every split's forward/backward sweeps run as ONE device batch per level.

    With `enc` set, q/t are RAW byte codes and every DP call transforms on
    the fly (the sweeps SWAP query/target roles, and the q/t representations
    are role-specific). `dist` = the pair's exact NW distance when the
    caller knows it (align_batch always does); it seeds the exact-distance-
    first banding of every sweep and is otherwise found by banded
    k-doubling."""
    if cell_limit is None:
        # read at call time so a patched MOVES_CELL_LIMIT governs the router
        # in _align_chunk and these base cases alike
        cell_limit = MOVES_CELL_LIMIT
    use_mask = enc is not None
    eq_flat = None
    if use_mask:
        # lut-mode ids reach A <= 256, past uint8; keep them int32
        t_dtype = np.uint8 if enc.eq_flat is None else np.int32
        as_q = lambda x: enc.q_lut[x]  # noqa: E731
        as_t = lambda x: enc.t_lut[x].astype(t_dtype)  # noqa: E731
        eq_flat = enc.eq_flat
    else:
        as_q = as_t = lambda x: x  # noqa: E731

    def pad(codes):
        return _pad_batch(codes, mult=1)

    def _exact_nw_dist(sq, st) -> int:
        """Exact NW distance by banded k-doubling (src/edlib.cpp:194-212):
        try a band, trust the result iff it is <= k (Ukkonen), else double."""
        lq, lt = len(sq), len(st)
        kd = abs(lq - lt) + 8
        while True:
            kd = 1 << int(np.ceil(np.log2(max(2, kd))))
            qb, qlb = pad([as_q(sq)])
            tb, tlb = pad([as_t(st)])
            if 4 * kd + 2 >= min(lq, lt):
                row = _lastrow(qb, qlb, tb, tlb, use_mask=use_mask, eq_flat=eq_flat,
                               device=device)[0]
                return int(row[lt])
            d = int(_banded_nw_dist(qb, qlb, tb, tlb, k=int(kd), use_mask=use_mask,
                                    eq_flat=eq_flat, device=device)[0])
            if d <= kd:
                return d
            kd *= 2

    if dist is None:
        dist = _exact_nw_dist(q, t) if len(q) and len(t) else None

    # ordered segments: ("ops", list) resolved | ("task", q, t, d) pending,
    # d = the segment's exact NW distance, inherited from the parent split
    # (leftScore/rightScore, src/edlib.cpp:1377-1385), so every level's
    # sweeps band to |i - jm| <= d instead of sweeping all Lq rows
    segments: list[tuple] = [("task", q, t, dist)]
    while any(s[0] == "task" for s in segments):
        base: list[int] = []
        jobs: list[int] = []
        for si, seg in enumerate(segments):
            if seg[0] != "task":
                continue
            _, sq, st, sd = seg
            lq, lt = len(sq), len(st)
            if lq == 0:
                segments[si] = ("ops", [EDOP_DELETE] * lt)
            elif lt == 0:
                segments[si] = ("ops", [EDOP_INSERT] * lq)
            elif lt == 1 or (not _hb_engages(lq, lt) and (lq + 1) * (lt + 1) <= cell_limit):
                # base iff the reference's own recursion would base here (it
                # re-checks the 1 MB rule per level, src/edlib.cpp:1190-1213)
                # AND the move tensor fits the device budget; lt == 1 must be
                # a base case (a split's jm would be 0 and never progress)
                base.append(si)
            else:
                jobs.append(si)
        # resolve base tasks in bounded bites
        bite_n = max(1, MOVES_BATCH_CELL_BUDGET // cell_limit)
        for bs in range(0, len(base), bite_n):
            part = base[bs : bs + bite_n]
            qb, qlb = pad([as_q(segments[si][1]) for si in part])
            tb, tlb = pad([as_t(segments[si][2]) for si in part])
            _, moves = dp_moves_batch(*_on(device, qb, qlb, tb, tlb), use_mask=use_mask,
                                      eq_flat=_eq_on(device, eq_flat))
            moves = moves.cpu().numpy()
            for ii, si in enumerate(part):
                _, sq, st = segments[si][:3]
                segments[si] = ("ops", _moves_to_ops(moves[ii], len(sq), len(st)))
        if not jobs:
            continue
        nj = len(jobs)
        # band half-width for this level: the fwd sweep needs rows
        # |i - jm| <= d, the bwd sweep additionally shifts by |lq - lt|; the
        # pow2 rounding decides banded-or-not and the K4/K5 route
        kb = 0
        max_lq = 0
        for si in jobs:
            _, sq, st, sd = segments[si]
            kb = max(kb, int(sd) + abs(len(sq) - len(st)))
            max_lq = max(max_lq, len(sq))
        kb = 1 << int(np.ceil(np.log2(max(8, kb + 1))))
        banded = 2 * kb + 1 < max_lq
        if banded:
            fq, ft, bq, bt = [], [], [], []
            for si in jobs:
                _, sq, st, _ = segments[si]
                jm = len(st) // 2
                # fwd band at column jm: f[i] = dist(q[:i], t[:jm])
                fq.append(sq)
                ft.append(st[:jm].copy())
                # bwd band at column lt-jm of the reversed halves:
                # cap[i''] = dist(q[i:], t[jm:]) with i = lq - i''
                bq.append(sq[::-1].copy())
                bt.append(st[jm:][::-1].copy())
            q_all, ql_all = pad([as_q(x) for x in fq + bq])
            t_all, tl_all = pad([as_t(x) for x in ft + bt])
            caps = _banded_final_column(q_all, ql_all, t_all, tl_all, k=int(kb),
                                        use_mask=use_mask, eq_flat=eq_flat, device=device)
        else:
            # narrow problems: the plain full sweep. fwd[i] = dist(q[:i],
            # t[:jm]) = lastrow(t[:jm], q)
            fwd_q, fwd_t, bwd_q, bwd_t = [], [], [], []
            for si in jobs:
                _, sq, st, _ = segments[si]
                jm = len(st) // 2
                fwd_q.append(st[:jm].copy())
                fwd_t.append(sq)
                bwd_q.append(st[jm:][::-1].copy())
                bwd_t.append(sq[::-1].copy())
            q_all, ql_all = pad([as_q(x) for x in fwd_q + bwd_q])
            t_all, tl_all = pad([as_t(x) for x in fwd_t + bwd_t])
            rows = _lastrow(q_all, ql_all, t_all, tl_all, use_mask=use_mask, eq_flat=eq_flat,
                            device=device)
        # replace each split task by (left half, right half) in order;
        # reverse iteration keeps earlier segment indices valid
        for rev_i in range(nj - 1, -1, -1):
            si = jobs[rev_i]
            _, sq, st, sd = segments[si]
            lq, lt = len(sq), len(st)
            jm = lt // 2
            best_tot = int(sd)
            if banded:
                fband = caps[rev_i]
                bband = caps[nj + rev_i]

                def fval(i, fband=fband, jm=jm):
                    bi = i - jm + kb
                    return int(fband[bi]) if 0 <= bi < 2 * kb + 1 else BIG

                def bval(i, bband=bband, lq=lq, lt=lt, jm=jm):
                    bi = (lq - i) - (lt - jm) + kb
                    return int(bband[bi]) if 0 <= bi < 2 * kb + 1 else BIG
            else:
                f = rows[rev_i, : lq + 1]
                b = rows[nj + rev_i, : lq + 1][::-1]
                fval = lambda i, f=f: int(f[i])  # noqa: E731
                bval = lambda i, b=b: int(b[i])  # noqa: E731
            # the reference's split-row scan order (src/edlib.cpp:1326-1361):
            # interior rows ascending FIRST, then the row-0 boundary, then the
            # row-Lq boundary (output-visible when row 0 ties an interior
            # row). Rows outside the band cannot be optimal, so the banded
            # scan sees every candidate the reference's does.
            i_star = -1
            lo = max(1, jm - kb) if banded else 1
            hi = min(lq - 1, jm + kb) if banded else lq - 1
            for i in range(lo, hi + 1):
                if fval(i) + bval(i) == best_tot:
                    i_star = i
                    break
            if i_star < 0 and fval(0) + bval(0) == best_tot:
                i_star = 0
            if i_star < 0:
                if fval(lq) + bval(lq) != best_tot:
                    raise AssertionError(f"Hirschberg split lost the optimum: {(lq, lt, sd)}")
                i_star = lq
            segments[si : si + 1] = [
                ("task", sq[:i_star].copy(), st[:jm].copy(), fval(i_star)),
                ("task", sq[i_star:].copy(), st[jm:].copy(), bval(i_star)),
            ]
    out: list[int] = []
    for seg in segments:
        out.extend(seg[1])
    return out


def align_batch(queries: list, targets: list, mode: str = "NW", task: str = "distance",
                k: int = -1, cigar_format: str = "extended", chunk: int = 4096,
                additional_equalities: list[tuple] | None = None,
                device: str | torch.device = "cuda") -> list[dict]:
    """Batched edlibAlign (src/edlib.cpp:141-296): one result dict per pair
    with keys editDistance, endLocations, startLocations, cigar, identical to
    the JAX package's and the reference library's values.
    `additional_equalities`: (charA, charB) pairs treated as equal, like
    EdlibEqualityPair (src/edlib.h:133-149). `device`: "cuda" (default;
    raises without CUDA) or "cpu" (the plain scans and kernel twins)."""
    from ..pipeline import resolve_device

    if mode not in ("NW", "SHW", "HW"):
        raise ValueError(f"mode must be NW, SHW or HW, got {mode!r}")
    if task not in ("distance", "locations", "path"):
        raise ValueError(f"task must be distance, locations or path, got {task!r}")
    P = len(queries)
    if len(targets) != P:
        raise ValueError(f"{P} queries but {len(targets)} targets")
    dev = resolve_device(device)
    results: list[dict] = []
    for s in range(0, P, chunk):
        results.extend(_align_chunk(
            [_encode_any(x) for x in queries[s : s + chunk]],
            [_encode_any(x) for x in targets[s : s + chunk]],
            mode, task, k, cigar_format, additional_equalities, device=dev,
        ))
    return results


def _align_chunk(qs, ts, mode, task, k, cigar_format, equalities=None, *, device) -> list[dict]:
    use_mask = equalities is not None
    enc = None
    eq_flat = None
    qs_raw, ts_raw = qs, ts
    if use_mask:
        # queries become per-position bitmasks (<= 32 symbols) or id*stride
        # gather offsets (lut mode); targets compact ids. Hirschberg gets the
        # RAW arrays + the encoding because its sweeps swap roles.
        enc = _equality_encoding(qs + ts, equalities)
        eq_flat = enc.eq_flat
        t_dtype = np.uint8 if eq_flat is None else np.int32
        qs = [enc.q_lut[x] for x in qs]
        ts = [enc.t_lut[x].astype(t_dtype) for x in ts]
    q, ql = _pad_batch(qs)
    t, tl = _pad_batch(ts)
    n = len(qs)

    dists = np.empty(n, dtype=np.int64)
    ends: list[list[int]] = []
    if mode == "NW" and 0 <= k and 2 * (2 * k + 1) < q.shape[1]:
        # small-k NW: the Ukkonen band, O(k*Lt) cells (src/edlib.cpp:559-571)
        band = _banded_nw_dist(q, ql, t, tl, k=int(k), use_mask=use_mask, eq_flat=eq_flat,
                               device=device)
        for p in range(n):
            if abs(int(ql[p]) - int(tl[p])) > k:
                dists[p] = k + 1  # corner outside the band: provably > k
            else:
                dists[p] = band[p]
            ends.append([int(tl[p]) - 1])
    elif mode == "SHW" and 0 <= k and 2 * (2 * k + 1) < q.shape[1]:
        # small-k SHW: every end the k-threshold contract can observe lies
        # in target columns [q_len - k, q_len + k]
        Ltc = min(t.shape[1], int(ql.max()) + k + 1)
        rows_b = _banded_shw_rows_routed(q, ql, t, tl, int(k), Ltc, use_mask, eq_flat,
                                         device=device)
        for p in range(n):
            row = rows_b[p, : min(Ltc, int(tl[p]))]
            d0 = int(ql[p])  # column j=0: empty target, always exact
            m = int(row.min()) if row.size else d0
            dists[p] = min(m, d0)
            es = [-1] if d0 == dists[p] else []
            es += [int(j) for j in np.flatnonzero(row == dists[p])]
            ends.append(es)
    elif mode == "HW" and 0 <= k and q.shape[1] > 2 * (2 * k + 256):
        # small-k HW on a tall query: K6 (one launch, exact rows) when
        # routed, else the adaptive-row chunk scan; values above k are BIG
        rows_b = _semi_rows_routed(q, ql, t, tl, True, use_mask, eq_flat, device=device)
        if rows_b is None:
            rows_b = _hw_banded_scan(q, ql, t, tl, int(k), use_mask, eq_flat, device=device)
        for p in range(n):
            row = rows_b[p, : tl[p]]
            d0 = int(ql[p])  # column j=0: empty target span
            m = int(row.min()) if row.size else d0
            dists[p] = min(m, d0)
            es = [-1] if d0 == dists[p] else []
            es += [int(j) for j in np.flatnonzero(row == dists[p])]
            ends.append(es)
    elif mode == "NW" and k < 0 and q.shape[1] >= NW_DOUBLING_MIN_LEN:
        # exact distance by banded k-doubling, the reference's own k=-1
        # strategy (src/edlib.cpp:194-212): band kd, trust any result <= kd,
        # double the unresolved pairs; a pair whose band would cover most of
        # its DP takes the one full sweep instead
        unresolved = np.arange(n)
        kd = 128
        while unresolved.size:
            m_len = np.minimum(ql[unresolved], tl[unresolved])
            go_full = unresolved[4 * kd + 2 >= m_len]
            unresolved = unresolved[4 * kd + 2 < m_len]
            for s in range(0, len(go_full), 512):
                part = go_full[s : s + 512]
                qi, qli = _rows_pow2(q, ql, part)
                ti, tli = _rows_pow2(t, tl, part)
                rows = _lastrow(qi, qli, ti, tli, use_mask=use_mask, eq_flat=eq_flat,
                                device=device)
                dists[part] = rows[np.arange(len(part)), tl[part]]
            if unresolved.size:
                qi, qli = _rows_pow2(q, ql, unresolved)
                ti, tli = _rows_pow2(t, tl, unresolved)
                d = _banded_nw_dist(qi, qli, ti, tli, k=int(kd), use_mask=use_mask,
                                    eq_flat=eq_flat, device=device)[: len(unresolved)]
                ok = (d <= kd) & (np.abs(ql[unresolved].astype(np.int64)
                                         - tl[unresolved]) <= kd)
                dists[unresolved[ok]] = d[ok]
                unresolved = unresolved[~ok]
            kd *= 2
        ends = [[int(tl[p]) - 1] for p in range(n)]
    else:
        rows = None
        if mode in ("SHW", "HW"):
            em = _semi_rows_routed(q, ql, t, tl, mode == "HW", use_mask, eq_flat, device=device)
            if em is not None:
                # prepend column 0 (empty target span): D(q_len, 0) = q_len
                rows = np.concatenate([ql.astype(np.int64)[:, None], em], axis=1)
        if rows is None:
            rows = _lastrow(q, ql, t, tl, free_target_prefix=(mode == "HW"), use_mask=use_mask,
                            eq_flat=eq_flat, device=device)
        for p in range(n):
            row = rows[p, : tl[p] + 1]
            if mode == "NW":
                dists[p] = row[tl[p]]
                ends.append([int(tl[p]) - 1])
            else:
                dists[p] = row.min()
                ends.append([int(j) - 1 for j in np.flatnonzero(row == dists[p])])

    # k-threshold contract (src/edlib.h:102-108)
    found = np.ones(n, dtype=bool) if k < 0 else (dists <= k)

    starts: list[list[int] | None] = [None] * n
    if task in ("locations", "path"):
        if mode == "HW":
            # reversed-SHW start derivation, batched over (pair, end): the
            # smallest optimal start per end (src/edlib.cpp:240-258)
            idx: list[tuple[int, int]] = []
            rqs: list[np.ndarray] = []
            rts: list[np.ndarray] = []
            for p in range(n):
                if not found[p]:
                    continue
                # the optimal start for end e spans at most q_len + dist
                # target chars, so the reversed target slice is clamped to it
                span = int(ql[p]) + int(dists[p]) + 1
                for e in ends[p]:
                    if e >= 0:
                        idx.append((p, e))
                        rqs.append(qs[p][::-1].copy())
                        lo = max(-1, e - span)
                        rts.append(ts[p][e : lo if lo >= 0 else None : -1].copy())
            if idx:
                rq, rql = _pad_batch(rqs)
                rt, rtl = _pad_batch(rts)
                rrows = _lastrow(rq, rql, rt, rtl, use_mask=use_mask, eq_flat=eq_flat,
                                 device=device)
            for p in range(n):
                if found[p]:
                    starts[p] = [0] * len(ends[p])
            for ii, (p, e) in enumerate(idx):
                row = rrows[ii, : rtl[ii] + 1]
                best_rev = int(np.flatnonzero(row == row.min()).max())  # last location
                starts[p][ends[p].index(e)] = e - (best_rev - 1)
        else:
            for p in range(n):
                if found[p]:
                    starts[p] = [0] * len(ends[p])

    cigars: list[str | None] = [None] * n
    if task == "path":
        # NW path on (q, t[start0:end0+1]) for the first location pair; pairs
        # whose move matrix would blow MOVES_CELL_LIMIT take Hirschberg
        extended = cigar_format == "extended"
        idx2: list[int] = []
        pqs: list[np.ndarray] = []
        pts: list[np.ndarray] = []
        for p in range(n):
            if not found[p] or not ends[p]:
                continue
            e0, s0 = ends[p][0], starts[p][0]
            if e0 < 0:
                cigars[p] = f"{len(qs[p])}I" if len(qs[p]) else ""
                continue
            sub_t = ts[p][s0 : e0 + 1].copy()
            if (_hb_engages(len(qs[p]), len(sub_t))
                    or (len(qs[p]) + 1) * (len(sub_t) + 1) > MOVES_CELL_LIMIT):
                cigars[p] = _ops_to_cigar(
                    _hirschberg_ops(qs_raw[p], ts_raw[p][s0 : e0 + 1].copy(), enc=enc,
                                    dist=int(dists[p]), device=device), extended)
                continue
            idx2.append(p)
            pqs.append(qs[p])
            pts.append(sub_t)
        if idx2:
            # group size-sorted pairs into bites whose PADDED cell total stays
            # under MOVES_BATCH_CELL_BUDGET
            def _flush_moves(bite: list[int]) -> None:
                pq, pql = _pad_batch([pqs[ii] for ii in bite])
                pt, ptl = _pad_batch([pts[ii] for ii in bite])
                _, moves = dp_moves_batch(*_on(device, pq, pql, pt, ptl), use_mask=use_mask,
                                          eq_flat=_eq_on(device, eq_flat))
                moves = moves.cpu().numpy()
                for jj, ii in enumerate(bite):
                    cigars[idx2[ii]] = _moves_to_cigar(moves[jj], int(pql[jj]), int(ptl[jj]),
                                                       extended)

            order = sorted(range(len(idx2)),
                           key=lambda ii: (len(pqs[ii]) + 1) * (len(pts[ii]) + 1), reverse=True)
            bite: list[int] = []
            max_lq = max_lt = 0
            for ii in order:
                nlq = max(max_lq, len(pqs[ii]) + 1)
                nlt = max(max_lt, len(pts[ii]) + 1)
                if bite and (len(bite) + 1) * nlq * nlt > MOVES_BATCH_CELL_BUDGET:
                    _flush_moves(bite)
                    bite = []
                    nlq, nlt = len(pqs[ii]) + 1, len(pts[ii]) + 1
                bite.append(ii)
                max_lq, max_lt = nlq, nlt
            if bite:
                _flush_moves(bite)

    out = []
    for p in range(n):
        if not found[p]:
            out.append({"editDistance": -1, "endLocations": [], "startLocations": None,
                        "cigar": None})
        else:
            out.append({"editDistance": int(dists[p]), "endLocations": ends[p],
                        "startLocations": starts[p], "cigar": cigars[p]})
    return out


def align(query, target, mode: str = "NW", task: str = "distance", k: int = -1,
          additionalEqualities: list | None = None,
          device: str | torch.device = "cuda") -> dict:
    """Single-pair convenience with the pip-edlib result shape and argument
    names (additionalEqualities matches the pip binding's keyword)."""
    r = align_batch([query], [target], mode=mode, task=task, k=k,
                    additional_equalities=additionalEqualities, device=device)[0]
    if r["editDistance"] == -1:
        return {"editDistance": -1, "locations": [], "cigar": None}
    starts = r["startLocations"] or [None] * len(r["endLocations"])
    return {
        "editDistance": r["editDistance"],
        "locations": list(zip(starts, r["endLocations"])),
        "cigar": r["cigar"],
    }
