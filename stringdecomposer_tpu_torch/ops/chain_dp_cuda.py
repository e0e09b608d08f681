"""K1 on the card: chain DP (csrc/chain_dp.cu), the block-walk kernel, P
(the int16 probe) and A (the ablation kernels of K1's lanes and cluster
bodies, csrc/chain_dp_ablate.cu).

`chain_dp_forward_cuda` has the contract of ops/chain_dp.chain_dp_forward.
It dispatches on the device of `windows`: a CPU tensor runs the plain
PyTorch twin, a CUDA tensor launches the kernels (and raises on anything
they do not take). Only the [B, max_blocks, 4] block records and the [B]
counts are meant to leave the device.

K1 has two routes with the same recurrence and tie rules. A monomer set
whose [M, L] column fits one block's shared memory (`smem_bytes`) takes the
shared route; a larger one takes the large route (`chain_dp_large_cuda`).
`body` names the kernel body a set runs. The shared route runs the lanes
body at L <= 512 (csrc/chain_dp_lanes.cuh: each lane owns C = ceil(L / 32)
<= 16 whole cells of a row, one pair scan per row, one barrier per
position) and the tiled body above it (csrc/chain_dp_tiled.cu: the lanes
body's row step over cells stepped from shared memory in register tiles,
long rows split over G warps, `tiled_layout`). The large route runs the
cluster body at L <= 512 where a cluster of at most 16 blocks holds the
rows (csrc/chain_dp_cluster.cuh, `cluster_plan`: a window's rows spread
over a thread block cluster, the lanes body's row step in each block, the
end scores exchanged through distributed shared memory) and the tiled
cluster body above it (the tiled body's rows in each block of a cluster,
`cluster_plan` with the tiled form's shared memory). Past one cluster of
16 blocks the grid routes (csrc/chain_dp_grid.cuh, `grid_plan`) run the
same bodies over K clusters a window, exchanging the chain max between
them through global memory each position ("grid" at L <= 512,
"grid_tiled" above), or split a row too long for one block's shared
memory over S blocks of a cluster ("split"). The chunked body
(csrc/chain_dp.cuh) keeps what none takes: a set past the whole card's
shared memory (with its column in a device-memory scratch, on the large
route) and `force_body=`. A shared-route set whose
tiled form does not fit one block (the padding of its rows) runs the tiled
cluster body. A C outside 1..16 is refused by the lanes and cluster
entries, a shape past one block by the tiled entries, never run on another
body; `force_body=` on the wrappers names a body for the checks and the
A/B, and raises where that body cannot take the set. Each body and route counts its
own launches, int32 and int16 state apart, and the lanes, cluster and grid
bodies' rows past LANES_LONG_L (C = 9..16, two rows a warp in registers)
apart from the shorter ones.

state_dtype="int16" (not the default: "auto" is int32) stores the column
and emits end / spend as int16, which halves K1's output bytes and lets
the shared route take monomer sets up to M = 240 at L = 192 (int32: 133).
It is refused where scores could wrap or reach the int16 sentinel (at unit
scores, W + L must stay below 8,191), and it runs only after P, launched
once per device, has agreed with its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..runtime.build import check, count_launch, library, stream_of
from . import chain_dp as plain

# Opt-in dynamic shared memory of one thread block on the H100 (sm_90).
SMEM_LIMIT = 232_448
# Device-memory scratch (scores and start pointers, 2 * state bytes per
# cell) that one launch of the large route may touch: a batch above it is
# launched in groups of windows, so that a launch's scratch stays in the
# 50 MB L2.
LARGE_SCRATCH_BYTES = 32 << 20
# the lanes and cluster bodies' longest row: 32 lanes x 16 cells
# (csrc/chain_dp_lanes.cuh kLanesMaxC)
LANES_MAX_L = 512
# rows past it (C = 9..16) are held two to a warp in registers, and their
# launches are counted apart ("_long")
LANES_LONG_L = 256
# the cluster body's largest cluster (csrc/chain_dp_cluster.cuh kClusterMax;
# above 8 blocks the launch allows a non-portable size)
CLUSTER_MAX = 16
# the tiled bodies' warps a block at most (csrc/chain_dp_tiled.cu kTiledWarps)
TILED_WARPS = 32
# `tiled_layout`'s model of a position's integer instructions on one SM: a
# cell's, a warp's row segment's fixed part (the chain max, the scan, the
# emit), and the warp carry's where a row is split; the SM issues them on 4
# schedulers
TILED_CELL_OPS, TILED_SEGMENT_OPS, TILED_SPLIT_OPS = 22, 250, 60
# the H100 SXM's SMs, over which a wave of the tiled cluster body's blocks
# spreads (`cluster_plan`), and the most blocks a window of the grid routes
# may take (`grid_plan`)
SM_COUNT = 132
# `grid_plan`'s model of what a position adds on the grid routes: the
# exchange of the chain max between a window's clusters through global
# memory (~1.5 us, an L2 round trip: one row step of the cluster body, ~3,000
# instructions of a scheduler), and the split form's second cluster barrier
# (~0.8 us)
GRID_EXCHANGE_ROWS, GRID_EXCHANGE_OPS, SPLIT_BARRIER_OPS = 1, 3000, 1600
# ablation variant -> csrc/chain_dp_variant.cuh Variant (base is K1's own launch)
_VARIANT_CODES = {v: i for i, v in enumerate(plain.VARIANTS)}
# the cells a lane of A's instances (csrc/chain_dp_ablate.cu kAblateC): the
# bench's 180 bp monomers padded to L = 192
ABLATE_C = 6


def smem_bytes(M: int, L: int, state_bytes: int = 4) -> int:
    """Shared memory the shared route needs for one window: scores and start
    pointers (state type), monomer codes (int8) per cell, plus two int32 per
    row (the kernel's launch computes the same, csrc/chain_dp.cuh)."""
    return 2 * M * 4 + 2 * M * L * state_bytes + M * L


def large_smem_bytes(M: int) -> int:
    """Shared memory the large route needs for one window: the end score and
    length of each row (int32)."""
    return 2 * M * 4


def route(M: int, L: int, state_bytes: int = 4) -> str:
    """The K1 route a monomer set of M rows padded to L takes: "shared" or
    "large"."""
    return "shared" if smem_bytes(M, L, state_bytes) <= SMEM_LIMIT else "large"


def reg_rows(L: int) -> int:
    """Rows a warp holds in registers in the lanes and cluster bodies'
    register form (csrc/chain_dp_lanes.cuh lanes_reg_rows): one up to
    LANES_LONG_L, two above."""
    return 1 if L <= LANES_LONG_L else 2


@functools.lru_cache(maxsize=4096)
def tiled_layout(R: int, L: int) -> tuple[int, int, int]:
    """(G, C, threads) of the tiled bodies for R rows a block padded to L:
    G warps a row, C = ceil(L / (32 G)) cells a lane, G then cut to the
    fewest warps that cover L at that C; a warp a row segment, at most
    TILED_WARPS warps (32 or more rows take one warp each in turn, G = 1).
    The bodies are bound by the SM's integer issue (PERF.md §6), so G
    is the one (up to floor(32 / R)) with the fewest instructions on the
    busiest of the 4 schedulers a position: ceil(R G / 4) segments of
    TILED_CELL_OPS x C + TILED_SEGMENT_OPS (+ TILED_SPLIT_OPS where G > 1),
    ties to fewer warps. So rows are split where a block has few of them:
    the 2,056 bp HOR unit's 2 rows take 2 warps each (C = 33), a block of
    one 17 kbp row 4 (C = 134), the 24 trimers one warp each."""
    top = 1 if R >= TILED_WARPS else max(1, min(TILED_WARPS // R, -(-L // 32)))
    G = min(range(1, top + 1), key=lambda g: (tiled_issue(R, g, -(-L // (32 * g))), g))
    C = -(-L // (32 * G))
    G = -(-L // (32 * C))
    return G, C, 32 * min(TILED_WARPS, R * G)


def tiled_issue(R: int, G: int, C: int) -> int:
    """`tiled_layout`'s model of one block of the tiled bodies: the integer
    instructions on the busiest of an SM's 4 schedulers a position, for R
    rows of G warps x C cells a lane."""
    return -(-R * G // 4) * (TILED_CELL_OPS * C + TILED_SEGMENT_OPS
                             + (TILED_SPLIT_OPS if G > 1 else 0))


def tiled_smem_bytes(M: int, R: int, G: int, C: int, state_bytes: int) -> int:
    """Shared memory of one block of the tiled bodies (csrc/chain_dp_tiled.cu
    tiled_smem_bytes): 8 * M bytes of parity buffers; 256 bytes of lane
    carries a row segment (R * G of them), and 24 more where G > 1 (a warp
    total, two boundary cells); the R rows' scores and pointers, P = 32 G C
    cells of the state type each, and their codes, ceil(C / 4) words a
    lane."""
    P, S = 32 * G * C, R * G
    return 8 * M + S * (256 + (24 if G > 1 else 0)) + R * (2 * state_bytes * P
                                                          + 128 * G * -(-C // 4))


def tiled_shape(M: int, L: int, state_bytes: int, cs: int):
    """The tiled bodies' launch for M rows padded to L over cs blocks (cs = 1:
    the shared route's tiled body): (R, "tiled", threads, smem), or None
    where it does not fit. Block r owns rows r*R .. min(M, (r+1)*R) - 1, R =
    ceil(M / cs), at least one; G and C from `tiled_layout(R, L)`; shared
    memory `tiled_smem_bytes` within SMEM_LIMIT."""
    if not (1 <= cs <= CLUSTER_MAX and L >= 1 and M >= 1):
        return None
    R = -(-M // cs)
    if (cs - 1) * R >= M:
        return None
    G, C, threads = tiled_layout(R, L)
    smem = tiled_smem_bytes(M, R, G, C, state_bytes)
    return (R, "tiled", threads, smem) if smem <= SMEM_LIMIT else None


def cluster_shape(M: int, L: int, state_bytes: int, cs: int):
    """The large route's cluster launch for M rows padded to L over clusters
    of cs blocks: (R, form, threads, smem), or None where it does not fit.
    Past LANES_MAX_L it is the tiled cluster body's, `tiled_shape`. Else the
    cluster body's: block r owns rows r*R .. min(M, (r+1)*R) - 1, R =
    ceil(M / cs), and must own at least one. R <= 32 rows live in registers
    ("regs"), a warp for every `reg_rows(L)` rows (32 * ceil(R / reg_rows)
    threads); more live in shared memory, lane-contiguous ("rows_dense"
    where L is 32 lanes x C cells, else "rows"), on the lanes body's 1,024
    or 512 threads. The shared memory (csrc/chain_dp_cluster.cuh
    cluster_smem_bytes): 8 * M bytes of parity buffers, plus the R rows' (2
    * state bytes + 1) * L bytes in the shared-memory forms, within
    SMEM_LIMIT."""
    if L > LANES_MAX_L:
        return tiled_shape(M, L, state_bytes, cs)
    if not (1 <= cs <= CLUSTER_MAX and L >= 1 and M >= 1):
        return None
    R = -(-M // cs)
    if (cs - 1) * R >= M:
        return None
    form, threads = lanes_form(R, L)
    smem = 8 * M + (R * L * (2 * state_bytes + 1) if R > 32 else 0)
    return (R, form, threads, smem) if smem <= SMEM_LIMIT else None


def lanes_form(R: int, L: int) -> tuple[str, int]:
    """(form, threads) of a block of R rows padded to L <= LANES_MAX_L in
    the cluster bodies: "regs" up to 32 rows, a warp for every
    `reg_rows(L)`; else "rows_dense" where L is 32 lanes x C cells, or
    "rows", on 1,024 threads at C <= 5 (and C = 6 dense), else 512."""
    C = -(-L // 32)
    if R <= 32:
        return "regs", 32 * -(-R // reg_rows(L))
    form = "rows_dense" if L == 32 * C else "rows"
    return form, 1024 if C <= 5 or (C == 6 and form == "rows_dense") else 512


def cluster_plan(M: int, L: int, state_bytes: int = 4, windows: int | None = None,
                 active=None):
    """(cs, R, form, threads, smem) of the large route's cluster launch for a
    monomer set: the cluster body's at L <= LANES_MAX_L, the tiled cluster
    body's above; None where no cluster of up to CLUSTER_MAX blocks fits
    (the rows too many for 16 blocks' shared memory, or a row too long for
    one block's). A pure function of its arguments. A launch of `windows`
    clusters runs in ceil(windows / active(cs)) waves, `active` giving how
    many clusters of cs blocks the card runs at once (the wrapper passes
    cudaOccupancyMaxActiveClusters; sizes it says 0 for are left out).
    The cluster body's rule: the fewest waves x (1 + rows a warp steps a
    position), ties to the fewest blocks a cluster; a warp steps ceil(R /
    warps) rows a position: one or two where the rows are in registers (R
    <= 32); the 1 is a position's fixed part (the chain max, the exchange,
    the barrier), about one row's work: on one H100 a wave of 5,500
    positions took ~8 ms x (1 + rows a warp). The tiled cluster body's: the
    fewest waves x the blocks a wave puts on one of SM_COUNT SMs x
    `tiled_issue` of a block, the busiest SM's integer issue a position,
    ties to the fewest blocks. Without `windows` and `active` every launch
    counts as one wave of one cluster, so the rule is the smallest cs whose
    rows fit registers, else the smallest cs that fits (the cluster body),
    and the cs with the least issue a block (the tiled one). On one H100
    (k1_ab.py --sweep, PERF.md) it picks the fastest size at 19 and 64
    windows of M = 264 and at 64 of M = 200, and one within 9 % of it at 19
    of M = 200; past 512 (k1_ab.py --tiled) the fastest at 19 windows of
    the 150 trimer variants."""
    shapes = [(cs, *shape) for cs in range(1, CLUSTER_MAX + 1)
              if (shape := cluster_shape(M, L, state_bytes, cs)) is not None]
    if windows is not None and active is not None:
        runs = {cs: active(cs) for cs, *_ in shapes}
        shapes = [plan for plan in shapes if runs[plan[0]] > 0] or shapes[:1]
    else:
        runs = None

    def cost(plan):
        cs, R, form, threads, _ = plan
        waves, at_once = 1, 1
        if runs and runs[cs] > 0:
            waves, at_once = -(-windows // runs[cs]), min(windows, runs[cs])
        if form == "tiled":
            G, C, _ = tiled_layout(R, L)
            return waves * -(-at_once * cs // SM_COUNT) * tiled_issue(R, G, C), cs
        return waves * (1 + -(-R // (threads // 32))), cs

    return min(shapes, key=cost) if shapes else None


def grid_smem_bytes(Me: int, L: int, R: int, state_bytes: int) -> int:
    """Shared memory of one block of the grid route at L <= LANES_MAX_L
    (csrc/chain_dp_cluster.cuh grid_smem_bytes): the parity buffers of the
    cluster's Me rows, two ints of the exchange, and the R rows where they
    live in shared memory (R > 32)."""
    return 8 * Me + 8 + (R * L * (2 * state_bytes + 1) if R > 32 else 0)


def grid_tiled_smem_bytes(Me: int, R: int, G: int, C: int, S: int, state_bytes: int) -> int:
    """Shared memory of one block of the grid route past LANES_MAX_L
    (csrc/chain_dp_tiled.cu grid_tiled_smem_bytes): the parity buffers of the
    cluster's Me rows and the exchange's two ints; a carry a lane for each of
    the R * G segments, and two boundary cells a segment where a row spans
    warps; the warp totals (S * G of the row where it spans S > 1 blocks,
    else R * G where G > 1); the split form's two incoming boundary cells;
    the rows as in `tiled_smem_bytes`."""
    P, Sg = 32 * G * C, R * G
    NT = S * G if S > 1 else (Sg if G > 1 else 0)
    return (8 * Me + 8 + 256 * Sg + 8 * NT + (16 * Sg if G > 1 or S > 1 else 0)
            + (16 if S > 1 else 0) + R * (2 * state_bytes * P + 128 * G * -(-C // 4)))


def split_layout(L: int, S: int) -> tuple[int, int, int]:
    """(G, C, threads) of a block of the split form, a row over S blocks:
    `tiled_layout` of one row of ceil(L / S) cells."""
    return tiled_layout(1, -(-L // S))


def grid_shape(M: int, L: int, state_bytes: int, K: int, cs: int, S: int = 1):
    """The grid route's launch for M rows padded to L over K clusters of cs
    blocks a window: (R, form, threads, smem), or None where it does not
    fit. S = 1: block j of the window's K * cs owns rows j*R .. min(M, (j+1)
    *R) - 1, R = ceil(M / (K cs)), at least one; at L <= LANES_MAX_L in the
    cluster body's forms (`cluster_shape`'s rule, `grid_smem_bytes`), above
    in the tiled form ("tiled", `tiled_layout(R, L)`,
    `grid_tiled_smem_bytes`). S > 1 ("split", past LANES_MAX_L): a row
    over S blocks of `split_layout(L, S)`, cs / S rows a cluster, every
    block with a row (K cs / S = M) and a first cell below L. Shared
    memory within SMEM_LIMIT."""
    if not (K >= 1 and 1 <= cs <= CLUSTER_MAX and M >= 1 and L >= 1 and S >= 1):
        return None
    if S > 1:
        if L <= LANES_MAX_L or cs % S or K * (cs // S) != M:
            return None
        G, C, threads = split_layout(L, S)
        if (S - 1) * 32 * G * C >= L:
            return None
        R, form, smem = 1, "split", grid_tiled_smem_bytes(cs // S, 1, G, C, S, state_bytes)
    else:
        R = -(-M // (K * cs))
        if (K * cs - 1) * R >= M:
            return None
        if L > LANES_MAX_L:
            G, C, threads = tiled_layout(R, L)
            form, smem = "tiled", grid_tiled_smem_bytes(cs * R, R, G, C, 1, state_bytes)
        else:
            form, threads = lanes_form(R, L)
            smem = grid_smem_bytes(cs * R, L, R, state_bytes)
    return (R, form, threads, smem) if smem <= SMEM_LIMIT else None


@functools.lru_cache(maxsize=256)
def _grid_shapes(M: int, L: int, state_bytes: int) -> tuple:
    """Every admissible (K, cs, S, R, form, threads, smem) of the grid
    routes with K cs <= SM_COUNT: S = 1 at K >= 2 (one cluster is the
    cluster bodies'); S > 1 only where one row does not fit a block in the
    tiled form."""
    out = []
    for cs in range(1, CLUSTER_MAX + 1):
        for K in range(2, SM_COUNT // cs + 1):
            if (shape := grid_shape(M, L, state_bytes, K, cs)) is not None:
                out.append((K, cs, 1, *shape))
    if L > LANES_MAX_L and tiled_shape(1, L, state_bytes, 1) is None:
        for S in range(2, CLUSTER_MAX + 1):
            for cs in range(S, CLUSTER_MAX + 1, S):
                K = M // (cs // S)
                if K * cs <= SM_COUNT and (shape := grid_shape(M, L, state_bytes, K, cs, S)):
                    out.append((K, cs, S, *shape))
    return tuple(out)


def grid_plan(M: int, L: int, state_bytes: int = 4, windows: int | None = None, active=None):
    """(K, cs, S, R, form, threads, smem) of the grid routes' launch for a
    set no cluster of 16 blocks holds, or None where none fits the card (K
    cs <= SM_COUNT blocks a window): `grid_shape`'s, K clusters of cs blocks
    a window. A pure function of its arguments. `active(plan)` gives how
    many clusters of the plan's shape the card runs at once (the wrapper
    passes cudaOccupancyMaxActiveClusters); a window's K clusters must all
    run at once, so plans it says fewer than K for are left out (where none
    is left, the cheapest is returned, and its launch raises), and a launch
    of `windows` windows runs in ceil(windows / floor(active / K)) waves.
    The cost, as `cluster_plan`'s: the waves x the blocks a wave puts on one
    of SM_COUNT SMs x a block's work a position (the cluster body's 1 +
    rows a warp steps, plus GRID_EXCHANGE_ROWS where K > 1; the tiled form's
    `tiled_issue`, plus GRID_EXCHANGE_OPS where K > 1 and SPLIT_BARRIER_OPS
    where S > 1); ties to the fewest blocks, then the fewest clusters."""
    shapes = list(_grid_shapes(M, L, state_bytes))
    runs = None
    if windows is not None and active is not None:
        runs = {plan: active(plan) for plan in shapes}
        shapes = [plan for plan in shapes if runs[plan] >= plan[0]] or shapes
    return min(shapes, key=lambda plan: grid_cost(plan, L, windows, runs and runs[plan])) \
        if shapes else None


def grid_cost(plan, L: int, windows: int | None = None, active: int | None = None):
    """`grid_plan`'s cost of one plan (K, cs, S, R, form, threads, smem) for
    `windows` windows where the card runs `active` of its clusters at once
    (without them, one window in one wave): (the model's time, blocks,
    clusters), compared in that order."""
    K, cs, S, R, form, threads, _ = plan
    waves, at_once = 1, 1
    if windows and active and active >= K:
        per = active // K
        waves, at_once = -(-windows // per), min(windows, per)
    if form in ("tiled", "split"):
        G, C, _ = tiled_layout(R, L) if S == 1 else split_layout(L, S)
        work = tiled_issue(R, G, C) + (GRID_EXCHANGE_OPS if K > 1 else 0) + (
            SPLIT_BARRIER_OPS if S > 1 else 0)
    else:
        work = 1 + -(-R // (threads // 32)) + GRID_EXCHANGE_ROWS
    return waves * -(-at_once * K * cs // SM_COUNT) * work, K * cs, K


# the grid routes' bodies by their form
GRID_BODY = {"tiled": "grid_tiled", "split": "split"}


def grid_body(form: str) -> str:
    """The body name of a grid plan's form: "grid" (the cluster body's
    forms, L <= LANES_MAX_L), "grid_tiled" or "split"."""
    return GRID_BODY.get(form, "grid")


def body(M: int, L: int, state_bytes: int = 4) -> str:
    """The K1 kernel body a monomer set runs. At L <= LANES_MAX_L: on the
    shared route "lanes"; on the large route "cluster" where `cluster_plan`
    finds a cluster of at most 16 blocks. Above: on the shared route "tiled"
    where the tiled form fits one block; else "cluster_tiled" where
    `cluster_plan` finds a cluster of the tiled form (the large route, and
    the shared-route sets whose padded rows do not fit one block). Past one
    cluster, the grid routes where `grid_plan` finds a plan on the card:
    "grid" (L <= LANES_MAX_L) and "grid_tiled", a window's rows over K
    clusters, or "split", a row too long for one block over the blocks of
    a cluster. The chunked body keeps the rest, "chunked" on the shared
    route and "large" on the large one (a set past the card's shared
    memory)."""
    shared = route(M, L, state_bytes) == "shared"
    if L <= LANES_MAX_L and shared:
        return "lanes"
    if L > LANES_MAX_L and shared and tiled_shape(M, L, state_bytes, 1) is not None:
        return "tiled"
    return _large_kind(M, L, state_bytes, "chunked" if shared else "large")


def _large_kind(M: int, L: int, state_bytes: int, none: str = "large") -> str:
    """The body of a set past the shared route's: the cluster bodies', else
    the grid routes', else `none`."""
    if cluster_plan(M, L, state_bytes) is not None:
        return "cluster" if L <= LANES_MAX_L else "cluster_tiled"
    plan = grid_plan(M, L, state_bytes)
    return none if plan is None else grid_body(plan[4])


# the bodies of each route, as `body` and the wrappers' `force_body=` name them
SHARED_BODIES = ("lanes", "tiled", "chunked")
GRID_BODIES = ("grid", "grid_tiled", "split")
LARGE_BODIES = ("cluster", "cluster_tiled") + GRID_BODIES + ("large",)


def check_monomer_set(M: int, L: int) -> None:
    """Raise for the chunked body's one bound: on the large route the end
    scores and lengths of all M rows must fit one block's shared memory (the
    other bodies keep only a cluster's rows' end scores a block)."""
    if large_smem_bytes(M) > SMEM_LIMIT:
        raise ValueError(
            f"monomer set too large for the chain-DP kernel: M={M} monomers need "
            f"{large_smem_bytes(M)} bytes of shared memory per window for their end "
            f"scores and lengths, above the {SMEM_LIMIT}-byte limit of one block "
            f"(8 * M <= {SMEM_LIMIT})"
        )


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def int16_probe_plain(v: torch.Tensor) -> torch.Tensor:
    """P's plain version: max(roll(v, 1, axis=1), v), jnp.roll semantics
    (lane c takes lane c - 1 mod cols)."""
    return torch.maximum(torch.roll(v, 1, 1), v)


def int16_probe_cuda(v: torch.Tensor) -> torch.Tensor:
    """P: the same on the card (csrc/chain_dp.cu), for a [rows, cols] int16
    tensor; a CPU tensor runs the plain version."""
    if not v.is_cuda:
        return int16_probe_plain(v)
    _require(v.dtype == torch.int16 and v.dim() == 2, "the probe takes a 2-D int16 tensor")
    v = v.contiguous()
    out = torch.empty_like(v)
    check(library().sd_int16_probe(v.data_ptr(), out.data_ptr(), v.shape[0], v.shape[1],
                                   stream_of(v)), "int16 probe kernel")
    count_launch(int16_probe_cuda)
    return out


int16_probe_cuda.launches = 0
_INT16_PROBE: dict[int, bool] = {}  # device index -> P agreed with its plain version


def int16_state_supported(device) -> bool:
    """Whether K1's int16 state may run on `device`: True on the CPU without
    launching anything (the plain twin computes in int16 tensors there); on
    a GPU, P runs once on seeded random int16 data against its plain
    version and the answer is cached. Build or launch errors propagate."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _INT16_PROBE:
        rng = np.random.default_rng(0)
        v = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, (8, 256), dtype=np.int16))
        v = v.to(device)
        _INT16_PROBE[idx] = bool(torch.equal(int16_probe_cuda(v), int16_probe_plain(v)))
    return _INT16_PROBE[idx]


def _state_dtype(state_dtype: str, windows, mono, ins, dele, mismatch, match) -> torch.dtype:
    """The range check of ops/chain_dp.resolve_state_dtype, then, for int16,
    the probe. A probe that fails to build or launch raises a ValueError
    chained from its error; it never turns into a quiet int32 run."""
    dt = plain.resolve_state_dtype(state_dtype, windows.shape[1], mono.shape[-1], ins, dele,
                                   mismatch, match)
    if dt == torch.int16:
        try:
            ok = int16_state_supported(windows.device)
        except (RuntimeError, OSError) as e:
            raise ValueError(
                f"state_dtype='int16' requested, but the int16 probe kernel failed on "
                f"{windows.device}: {e}. Use 'auto' or 'int32'."
            ) from e
        if not ok:
            raise ValueError(
                f"state_dtype='int16' requested, but the int16 probe kernel disagrees with "
                f"its plain version on {windows.device}. Use 'auto' or 'int32'."
            )
    return dt


def _prologue(windows, window_lens, mono, mono_lens, dele, mismatch, match, dt):
    """Check the inputs of a launch and build column 0 and the outputs:
    (windows, mono, mono_lens, dp0 [B, M, L], end and spend [B, W, M]),
    the last three in the state type `dt`."""
    B, W = windows.shape
    M, L = mono.shape[-2], mono.shape[-1]
    dev = windows.device
    for name, x, t in (("windows", windows, torch.int8), ("window_lens", window_lens, torch.int32),
                       ("mono", mono, torch.int8), ("mono_lens", mono_lens, torch.int32)):
        _require(x.device == dev, f"{name} is on {x.device}, windows on {dev}")
        _require(x.dtype == t, f"{name} must be {t}, got {x.dtype}")
    _require(mono.dim() in (2, 3) and mono_lens.dim() == mono.dim() - 1,
             "mono must be [M, L] or [B, M, L] with lens [M] or [B, M]")
    _require(mono.dim() == 2 or mono.shape[0] == B, "per-window mono needs B rows")
    _require(M >= 1 and L >= 1 and W >= 1, "empty monomer set or window")
    windows = windows.contiguous()
    mono = mono.contiguous()
    mono_lens = mono_lens.contiguous()
    mono_b, lens_b = plain.broadcast_monomers(mono, mono_lens, B)
    dp0 = plain.init_column(windows, mono_b, lens_b, dele, mismatch, match, dt).contiguous()
    end = torch.empty((B, W, M), dtype=dt, device=dev)
    return windows, mono, mono_lens, dp0, end, torch.empty_like(end)


def _epilogue(end, spend, window_lens, max_blocks, return_debug):
    blocks, counts = block_walk_cuda(end, spend, window_lens, max_blocks)
    if return_debug:
        B = end.shape[0]
        head = torch.full((B, 1), plain.INF, dtype=torch.int32, device=end.device)
        chain = torch.cat([head, end[:, :-1].amax(dim=2).to(torch.int32)], dim=1)
        return blocks, counts, (chain, end.to(torch.int32), spend.to(torch.int32))
    return blocks, counts


def _launch(fn, lead, windows, mono, mono_lens, dp0, end, spend, b0, b1, scratch,
            ins, dele, mismatch, match, tail=()):
    """One launch of a K1 entry point (`fn`, whose first int arguments are
    `lead`) over windows [b0, b1); `scratch` holds the pointer arguments
    that follow dp0 (sd_chain_dp: the large route's pointer scratch or None;
    sd_chain_dp_lanes: none), `tail` those before the stream (the grid
    routes' slots and fault word)."""
    M, L = mono.shape[-2], mono.shape[-1]
    per_window = mono.dim() == 3
    m_w, l_w = (mono[b0:b1], mono_lens[b0:b1]) if per_window else (mono, mono_lens)
    return fn(
        *lead, windows[b0:b1].data_ptr(), m_w.data_ptr(), M * L if per_window else 0,
        l_w.data_ptr(), M if per_window else 0, dp0[b0:b1].data_ptr(), *scratch,
        end[b0:b1].data_ptr(), spend[b0:b1].data_ptr(), b1 - b0, windows.shape[1], M, L,
        ins, dele, mismatch, match, *tail, stream_of(windows),
    )


def _counter(dt: torch.dtype, kind: str = "", L: int = 0) -> str:
    """The launch counter of a K1 body (`kind`: "" for the chunked body,
    "lanes", "cluster", "tiled", "cluster_tiled", "grid", "grid_tiled" or
    "split"), the lanes, cluster and grid bodies' rows past LANES_LONG_L
    and int16 state apart."""
    long = "_long" if kind in ("lanes", "cluster", "grid") and L > LANES_LONG_L else ""
    return f"launches{'_' + kind if kind else ''}{long}{'_int16' if dt == torch.int16 else ''}"


def chain_dp_forward_cuda(
    windows: torch.Tensor,
    window_lens: torch.Tensor,
    mono: torch.Tensor,
    mono_lens: torch.Tensor,
    ins: int = -1,
    dele: int = -1,
    mismatch: int = -1,
    match: int = 1,
    max_blocks: int = 0,
    return_debug: bool = False,
    state_dtype: str = "auto",
    force_body: str | None = None,
):
    """Same contract and outputs as ops/chain_dp.chain_dp_forward. The set
    runs the body `body(M, L, state bytes)` names, or the one `force_body`
    names (for the checks and the A/B: "lanes" at L <= LANES_MAX_L, "tiled"
    where its form fits one block, "chunked" where the column does; a
    large-route body goes to chain_dp_large_cuda); a body that cannot take
    the set raises, on any device. The large route's bodies, the grid
    routes' among them, run in chain_dp_large_cuda."""
    kw = dict(ins=ins, dele=dele, mismatch=mismatch, match=match, max_blocks=max_blocks,
              return_debug=return_debug, state_dtype=state_dtype)
    dt = _state_dtype(state_dtype, windows, mono, ins, dele, mismatch, match)
    M, L = mono.shape[-2], mono.shape[-1]
    kind = force_body or body(M, L, dt.itemsize)
    if kind in LARGE_BODIES:
        return chain_dp_large_cuda(windows, window_lens, mono, mono_lens, force_body=force_body,
                                   **kw)
    _require(kind in SHARED_BODIES, f"unknown K1 body {kind!r}; known: "
             f"{', '.join(SHARED_BODIES + LARGE_BODIES)}")
    fits = {"lanes": route(M, L, dt.itemsize) == "shared" and L <= LANES_MAX_L,
            "tiled": tiled_shape(M, L, dt.itemsize, 1) is not None,
            "chunked": route(M, L, dt.itemsize) == "shared"}[kind]
    _require(fits, f"the {kind} body cannot take M={M}, L={L} at {dt.itemsize} state bytes")
    if not windows.is_cuda:
        return plain.chain_dp_forward(windows, window_lens, mono, mono_lens, **kw)
    B, W = windows.shape
    windows, mono, mono_lens, dp0, end, spend = _prologue(
        windows, window_lens, mono, mono_lens, dele, mismatch, match, dt)
    if B > 0:
        lib = library()
        fn, lead, scratch = {"lanes": (lib.sd_chain_dp_lanes, (dt.itemsize,), ()),
                             "tiled": (lib.sd_chain_dp_tiled,
                                       (dt.itemsize, *tiled_layout(M, L)[:2]), ()),
                             "chunked": (lib.sd_chain_dp, (0, dt.itemsize), (None,))}[kind]
        check(_launch(fn, lead, windows, mono, mono_lens, dp0, end, spend, 0, B, scratch,
                      ins, dele, mismatch, match), f"chain_dp {kind} kernel")
        count_launch(chain_dp_forward_cuda, _counter(dt, "" if kind == "chunked" else kind, L))
    return _epilogue(end, spend, window_lens, max_blocks or W, return_debug)


chain_dp_forward_cuda.launches = 0  # the chunked body (shared route, past the tiled form)
chain_dp_forward_cuda.launches_int16 = 0
chain_dp_forward_cuda.launches_lanes = 0  # the lanes body (shared route, L <= 256)
chain_dp_forward_cuda.launches_lanes_int16 = 0
chain_dp_forward_cuda.launches_lanes_long = 0  # the lanes body at 256 < L <= 512
chain_dp_forward_cuda.launches_lanes_long_int16 = 0
chain_dp_forward_cuda.launches_tiled = 0  # the tiled body (shared route, L > 512)
chain_dp_forward_cuda.launches_tiled_int16 = 0


def _groups(B: int, M: int, L: int, dt: torch.dtype) -> int:
    """Windows per large-route launch: the scratch of one launch (2 * state
    bytes per cell) stays under LARGE_SCRATCH_BYTES."""
    return max(1, min(B, LARGE_SCRATCH_BYTES // (2 * dt.itemsize * M * L)))


def cluster_occupancy(M: int, L: int, state_bytes: int, cluster_size: int, B: int = 1) -> int:
    """cudaOccupancyMaxActiveClusters for the large route's cluster launch of
    B windows at (M, L) over clusters of `cluster_size` blocks (the tiled
    cluster body's past LANES_MAX_L), on the current device: how many such
    clusters the card runs at once (0: none)."""
    shape = cluster_shape(M, L, state_bytes, cluster_size)
    _require(shape is not None, f"cluster_size={cluster_size} does not fit M={M}, L={L}")
    lead = (state_bytes, cluster_size, shape[0])
    if shape[1] == "tiled":
        fn, lead = library().sd_chain_dp_cluster_tiled_occupancy, (*lead,
                                                                   *tiled_layout(shape[0], L)[:2])
    else:
        fn = library().sd_chain_dp_cluster_occupancy
    n = ctypes.c_int(0)
    check(fn(*lead, B, M, L, ctypes.byref(n)), "chain_dp cluster occupancy")
    return n.value


def _cluster_launch(M: int, L: int, state_bytes: int, cluster_size, windows=None):
    """The large route's cluster launch (cs, R, form, threads, smem): the
    plan's for `windows` clusters on the current device (or, without them,
    the plan's default), or `cluster_size`'s where given, which must fit;
    None: none fits."""
    if cluster_size is None:
        active = None
        if windows:
            def active(cs):
                return cluster_occupancy(M, L, state_bytes, cs, windows)
        return cluster_plan(M, L, state_bytes, windows or None, active)
    shape = cluster_shape(M, L, state_bytes, cluster_size)
    _require(shape is not None,
             f"cluster_size={cluster_size} is not admitted for M={M}, L={L}, state bytes "
             f"{state_bytes}: it needs 1 <= cluster_size <= {CLUSTER_MAX}, at least one row a "
             f"block and the shared memory within {SMEM_LIMIT} bytes")
    return (cluster_size, *shape)


_GRID_ACTIVE: dict = {}  # (device, M, L, state bytes, cs, S, R) -> clusters at once


def grid_occupancy(M: int, L: int, state_bytes: int, plan) -> int:
    """cudaOccupancyMaxActiveClusters for the grid launch `plan` (K, cs, S,
    R, form, ...) at (M, L) on the current device: how many of its clusters
    the card runs at once (0: none). It does not depend on K; cached."""
    K, cs, S, R, form = plan[:5]
    key = (torch.cuda.current_device(), M, L, state_bytes, cs, S, R)
    if key not in _GRID_ACTIVE:
        n = ctypes.c_int(0)
        lib = library()
        if form in ("tiled", "split"):
            G, C, _ = tiled_layout(R, L) if S == 1 else split_layout(L, S)
            code = lib.sd_chain_dp_grid_tiled_occupancy(state_bytes, K, cs, R, G, C, S, 1, M, L,
                                                        ctypes.byref(n))
        else:
            code = lib.sd_chain_dp_grid_occupancy(state_bytes, K, cs, R, 1, M, L,
                                                  ctypes.byref(n))
        check(code, "chain_dp grid occupancy")
        _GRID_ACTIVE[key] = n.value
    return _GRID_ACTIVE[key]


def _grid_launch(M: int, L: int, state_bytes: int, kind: str, grid, windows=None):
    """The grid launch (K, cs, S, R, form, threads, smem) a grid body runs:
    `grid` = (K, cs, S) where given, which must fit; else `grid_plan`'s,
    for `windows` windows with the card's occupancy where given (a CUDA
    device), among the plans of `kind`. Raises where none fits."""
    if grid is not None:
        K, cs, S = grid
        shape = grid_shape(M, L, state_bytes, K, cs, S)
        _require(shape is not None and K * cs <= SM_COUNT and grid_body(shape[1]) == kind,
                 f"grid={tuple(grid)} is not admitted for the {kind} body at M={M}, L={L}, "
                 f"state bytes {state_bytes}: it needs K x cs <= {SM_COUNT} blocks, cs <= "
                 f"{CLUSTER_MAX}, every block with a row and the shared memory within "
                 f"{SMEM_LIMIT} bytes")
        return (K, cs, S, *shape)
    plan = grid_plan(M, L, state_bytes)
    _require(plan is not None and grid_body(plan[4]) == kind,
             f"the {kind} body cannot take M={M}, L={L} at {state_bytes} state bytes")
    if windows:
        plan = grid_plan(M, L, state_bytes, windows,
                         lambda p: grid_occupancy(M, L, state_bytes, p))
    return plan


def chain_dp_large_cuda(
    windows: torch.Tensor,
    window_lens: torch.Tensor,
    mono: torch.Tensor,
    mono_lens: torch.Tensor,
    ins: int = -1,
    dele: int = -1,
    mismatch: int = -1,
    match: int = 1,
    max_blocks: int = 0,
    return_debug: bool = False,
    state_dtype: str = "auto",
    cluster_size: int | None = None,
    force_body: str | None = None,
    grid: tuple[int, int, int] | None = None,
):
    """K1's large route, for any monomer-set size (chain_dp_forward_cuda
    takes it when the shared route does not fit; it is called directly to
    check it against the shared route and to sweep cluster sizes). Same
    contract and outputs. It runs the cluster body at L <= LANES_MAX_L and
    the tiled cluster body above, over clusters of `cluster_plan`'s size, or
    of `cluster_size` where given (checked against what shared memory
    admits, on any device); past one cluster the grid routes, over
    `grid_plan`'s K clusters of cs blocks (S blocks a row in the split
    form), or `grid` = (K, cs, S)'s where given; where none fits the card,
    the chunked body with its device-memory scratch. `force_body` names one
    for the checks and the A/B: "cluster" (L <= LANES_MAX_L),
    "cluster_tiled" (L > LANES_MAX_L), "grid", "grid_tiled", "split" or
    "large" (the chunked body); one that cannot take the set raises. A
    cluster the card cannot schedule, or a grid plan whose K clusters the
    card cannot run at once, raises; it never falls back. The grid routes
    wait for their launches and raise where a read of another cluster's
    chain max ran out of time (csrc/chain_dp_grid.cuh)."""
    dt = _state_dtype(state_dtype, windows, mono, ins, dele, mismatch, match)
    B, W = windows.shape
    M, L = mono.shape[-2], mono.shape[-1]
    sb = dt.itemsize
    _require(force_body in (None,) + LARGE_BODIES,
             f"the large route runs {', '.join(LARGE_BODIES)}, not {force_body!r}")
    short = force_body in ("cluster", "grid")  # the lanes row step's bodies
    _require(force_body in (None, "large") or (L <= LANES_MAX_L) == short,
             f"the {force_body} body takes L {'<=' if short else '>'} {LANES_MAX_L}, not {L}")
    _require(force_body != "large" or cluster_size is None,
             "the chunked body takes no cluster_size")
    _require(cluster_size is None or grid is None, "cluster_size and grid exclude each other")
    kind = force_body
    if kind is None:
        if grid is not None:
            shape = grid_shape(M, L, sb, *grid)
            kind = grid_body(shape[1]) if shape else "grid"  # `_grid_launch` refuses None
        elif cluster_size is not None:
            kind = "cluster" if L <= LANES_MAX_L else "cluster_tiled"
        else:
            kind = _large_kind(M, L, sb)
    _require(grid is None or kind in GRID_BODIES, f"the {kind} body takes no grid")
    _require(cluster_size is None or kind in ("cluster", "cluster_tiled"),
             f"the {kind} body takes no cluster_size")
    plan = None
    if kind in ("cluster", "cluster_tiled"):
        plan = _cluster_launch(M, L, sb, cluster_size, B if windows.is_cuda else None)
        _require(plan is not None,
                 f"the {kind} body cannot take M={M}, L={L} at {sb} state bytes")
    elif kind in GRID_BODIES:
        plan = _grid_launch(M, L, sb, kind, grid, B if windows.is_cuda else None)
    if not windows.is_cuda:
        return plain.chain_dp_forward(
            windows, window_lens, mono, mono_lens, ins=ins, dele=dele, mismatch=mismatch,
            match=match, max_blocks=max_blocks, return_debug=return_debug,
            state_dtype=state_dtype)
    windows, mono, mono_lens, dp0, end, spend = _prologue(
        windows, window_lens, mono, mono_lens, dele, mismatch, match, dt)
    lib = library()
    if kind in ("cluster", "cluster_tiled"):
        cs, R, form, threads, smem = plan
        if B > 0:
            if cluster_occupancy(M, L, sb, cs, B) == 0:
                raise RuntimeError(
                    f"chain_dp {kind} body cannot be scheduled: cudaOccupancyMaxActiveClusters "
                    f"is 0 for M={M}, L={L}, cluster_size={cs} ({R} rows, {threads} threads "
                    f"and {smem} bytes of shared memory a block)")
            fn, lead = ((lib.sd_chain_dp_cluster_tiled,
                         (sb, cs, R, *tiled_layout(R, L)[:2])) if form == "tiled" else
                        (lib.sd_chain_dp_cluster, (sb, cs, R)))
            check(_launch(fn, lead, windows, mono, mono_lens, dp0, end, spend, 0, B, (), ins,
                          dele, mismatch, match), f"chain_dp {kind} kernel")
            count_launch(chain_dp_large_cuda, _counter(dt, kind, L))
        return _epilogue(end, spend, window_lens, max_blocks or W, return_debug)
    if kind in GRID_BODIES:
        if B > 0:
            _grid_run(lib, kind, plan, dt, windows, mono, mono_lens, dp0, end, spend, ins, dele,
                      mismatch, match)
        return _epilogue(end, spend, window_lens, max_blocks or W, return_debug)
    check_monomer_set(M, L)
    group = _groups(B, M, L, dt)
    sp = torch.empty((group, M, L), dtype=dt, device=windows.device)
    for b0 in range(0, B, group):  # one launch per group; sp is reused in stream order
        check(_launch(lib.sd_chain_dp, (1, sb), windows, mono, mono_lens, dp0, end,
                      spend, b0, min(B, b0 + group), (sp.data_ptr(),), ins, dele, mismatch,
                      match),
              "chain_dp large-route kernel")
        count_launch(chain_dp_large_cuda, _counter(dt))
    return _epilogue(end, spend, window_lens, max_blocks or W, return_debug)


def _grid_run(lib, kind, plan, dt, windows, mono, mono_lens, dp0, end, spend, ins, dele,
              mismatch, match):
    """The grid routes' launches: at most floor(active / K) windows a
    launch, so that every cluster of a launch runs at once on an idle card
    (raises where even one window's K clusters cannot), one launch after
    another in stream order; then a wait for the fault word."""
    B = windows.shape[0]
    M, L = mono.shape[-2], mono.shape[-1]
    sb = dt.itemsize
    K, cs, S, R, form, threads, smem = plan
    active = grid_occupancy(M, L, sb, plan)
    if active < K:
        raise RuntimeError(
            f"chain_dp {kind} body cannot run: its {K} clusters of {cs} blocks a window cannot "
            f"all be resident at once (cudaOccupancyMaxActiveClusters is {active} for M={M}, "
            f"L={L}, {R} rows, {threads} threads and {smem} bytes of shared memory a block)")
    per = active // K
    if form in ("tiled", "split"):
        fn = lib.sd_chain_dp_grid_tiled
        lead = (sb, K, cs, R, *(tiled_layout(R, L) if S == 1 else split_layout(L, S))[:2], S)
    else:
        fn, lead = lib.sd_chain_dp_grid, (sb, K, cs, R)
    groups = -(-B // per)
    slots = torch.zeros((groups, 2 * min(B, per) * K), dtype=torch.int64, device=windows.device)
    fault = torch.zeros((1,), dtype=torch.int32, device=windows.device)
    for g in range(groups):
        b0, b1 = g * per, min(B, (g + 1) * per)
        check(_launch(fn, lead, windows, mono, mono_lens, dp0, end, spend, b0, b1, (), ins,
                      dele, mismatch, match, (slots[g].data_ptr(), fault.data_ptr())),
              f"chain_dp {kind} kernel")
        count_launch(chain_dp_large_cuda, _counter(dt, kind, L))
    if int(fault.item()):
        raise RuntimeError(
            f"chain_dp {kind} body: a read of another cluster's chain max ran out of time "
            f"(K={K} clusters of {cs} blocks a window, {per} windows a launch): the clusters "
            "of a window did not all run at once; the results are void")


chain_dp_large_cuda.launches = 0  # the chunked body (past the card's shared memory)
chain_dp_large_cuda.launches_int16 = 0
chain_dp_large_cuda.launches_cluster = 0  # the cluster body (L <= 256)
chain_dp_large_cuda.launches_cluster_int16 = 0
chain_dp_large_cuda.launches_cluster_long = 0  # the cluster body at 256 < L <= 512
chain_dp_large_cuda.launches_cluster_long_int16 = 0
chain_dp_large_cuda.launches_cluster_tiled = 0  # the tiled cluster body (L > 512)
chain_dp_large_cuda.launches_cluster_tiled_int16 = 0
chain_dp_large_cuda.launches_grid = 0  # the grid route, rows over K clusters (L <= 256)
chain_dp_large_cuda.launches_grid_int16 = 0
chain_dp_large_cuda.launches_grid_long = 0  # the grid route at 256 < L <= 512
chain_dp_large_cuda.launches_grid_long_int16 = 0
chain_dp_large_cuda.launches_grid_tiled = 0  # the grid route past 512, rows over K clusters
chain_dp_large_cuda.launches_grid_tiled_int16 = 0
chain_dp_large_cuda.launches_split = 0  # the grid route's split form, a row over S blocks
chain_dp_large_cuda.launches_split_int16 = 0


def chain_dp_ablate_cuda(windows, mono, mono_lens, dp0, variant: str, large: bool,
                         ins=-1, dele=-1, mismatch=-1, match=1, out=None,
                         cluster_size: int | None = None):
    """A: one of K1's two main-path bodies with one cost centre removed
    (ops/chain_dp.VARIANTS; csrc/chain_dp_ablate.cu), from the given int32
    column 0 `dp0` [B, M, L]. large=False: the lanes body at its form with
    the rows in registers and 6 cells a lane (M <= 32, 160 < L <= 192);
    large=True: the cluster body at its form with the rows in shared memory
    (L = 192, more than 32 rows a block) over clusters of `cluster_plan`'s
    size for B windows, or of `cluster_size`. "base" is K1's own production
    launch of that body (sd_chain_dp_lanes, sd_chain_dp_cluster). A set
    outside the instantiated forms raises, on any device. Returns (end,
    spend) [B, W, M] int32, knowingly not K1's for any variant but base;
    `out` may pass them in, zero-filled (noemit writes only the last
    position), to keep allocation out of a timed call. A CPU tensor runs
    ops/chain_dp.chain_dp_ablate, with `cluster_size` where large."""
    _require(variant in _VARIANT_CODES, f"unknown ablation variant {variant!r}; known: "
             f"{', '.join(plain.VARIANTS)}")
    B, W = windows.shape
    M, L = mono.shape[-2], mono.shape[-1]
    _require(mono.dim() == 2 and windows.dtype == torch.int8 and mono.dtype == torch.int8
             and mono_lens.dtype == torch.int32 and dp0.dtype == torch.int32
             and dp0.shape == (B, M, L) and dp0.is_contiguous(),
             "the ablation takes int8 windows [B, W], shared int8 mono [M, L], int32 lens "
             "and a contiguous int32 dp0 [B, M, L]")
    _require(-(-L // 32) == ABLATE_C, f"A is built at {ABLATE_C} cells a lane "
             f"({32 * ABLATE_C - 31} <= L <= {32 * ABLATE_C}), not L={L}")
    cs = R = 0
    if large:
        cs, R, form, _, _ = _cluster_launch(M, L, 4, cluster_size,
                                            B if windows.is_cuda else None) or (0, 0, None, 0, 0)
        _require(form == "rows_dense", f"A's cluster body is built with its rows in shared "
                 f"memory at L = {32 * ABLATE_C} (more than 32 rows a block), not M={M}, L={L} "
                 f"over {cs} blocks ({form})")
    else:
        _require(M <= 32, f"A's lanes body is built with its rows in registers (M <= 32), "
                 f"not M={M}")
    if not windows.is_cuda:
        return plain.chain_dp_ablate(windows, mono, mono_lens, dp0, variant, ins, dele,
                                     mismatch, match, cs if large else None)
    windows, mono, mono_lens = windows.contiguous(), mono.contiguous(), mono_lens.contiguous()
    if out is None:
        out = (torch.zeros((B, W, M), dtype=torch.int32, device=windows.device),
               torch.zeros((B, W, M), dtype=torch.int32, device=windows.device))
    end, spend = out
    if B > 0:
        lib = library()
        if variant == "base":
            fn, lead = ((lib.sd_chain_dp_cluster, (4, cs, R)) if large else
                        (lib.sd_chain_dp_lanes, (4,)))
        else:
            fn, lead = lib.sd_chain_dp_ablate, (_VARIANT_CODES[variant], int(large), cs, R)
        check(_launch(fn, lead, windows, mono, mono_lens, dp0, end, spend, 0, B, (), ins, dele,
                      mismatch, match),
              f"chain_dp ablation kernel {variant} ({'cluster' if large else 'lanes'} body)")
        count_launch(chain_dp_ablate_cuda, ablate_counter(variant, large))
    return end, spend


def ablate_counter(variant: str, large: bool) -> str:
    """The launch counter of one ablation kernel on chain_dp_ablate_cuda
    (`large`: the cluster body's)."""
    return f"launches_{'large_' if large else ''}{variant}"


chain_dp_ablate_cuda.__dict__.update(
    {ablate_counter(v, large): 0 for v in plain.VARIANTS for large in (False, True)})


def block_walk_cuda(end, spend, window_lens, max_blocks: int):
    """Same contract as ops/chain_dp.block_walk; one thread per window."""
    if not end.is_cuda:
        return plain.block_walk(end, spend, window_lens, max_blocks)
    B, W, M = end.shape
    _require(end.dtype in (torch.int32, torch.int16) and spend.dtype == end.dtype,
             "end and spend must both be int32 or both int16")
    for name, x in (("end", end), ("spend", spend), ("window_lens", window_lens)):
        _require(x.device == end.device, f"{name} must be on {end.device}")
    _require(window_lens.dtype == torch.int32, "window_lens must be int32")
    _require(spend.shape == end.shape and window_lens.shape == (B,), "shape mismatch")
    end, spend, window_lens = end.contiguous(), spend.contiguous(), window_lens.contiguous()
    blocks = torch.zeros((B, max_blocks, 4), dtype=torch.int32, device=end.device)
    counts = torch.empty((B,), dtype=torch.int32, device=end.device)
    if B > 0:
        check(library().sd_block_walk(
            end.dtype.itemsize, end.data_ptr(), spend.data_ptr(), window_lens.data_ptr(),
            blocks.data_ptr(), counts.data_ptr(), B, W, M, max_blocks,
            stream_of(end),
        ), "block_walk kernel")
        count_launch(block_walk_cuda)
    return blocks, counts


block_walk_cuda.launches = 0
