"""K4, K5 and K6 on the card: the banded and semi-global sweeps of the
alignment API (csrc/banded_warp.cu, csrc/myers_warp.cu, csrc/banded.cu).

Each wrapper has the contract of its twin in ops/banded.py and dispatches
on the device of `q`: a CPU tensor runs the twin, a CUDA tensor launches the
kernel (exact at any band width and query length) and raises on anything it
does not take. Each kernel has two routes, each with its own launch counter:
- the warp route (`launches`), a warp a pair with the band in registers, up
  to WARP_MAX_WORDS items a warp: K4's band lanes (csrc/banded_warp.cu; k <=
  255), K5's and K6's 32-row words (csrc/myers_warp.cu; k <= 8,191 in K5,
  Lq <= 16,384 in K6). K6 under HW splits a long target into segments, one
  warp each (`segment_plan`);
- the wide route (`launches_wide`; csrc/banded.cu) past that: a block a
  pair whose threads are a pipeline of register stages, K4's and K5's in
  absolute rows (ops/banded.banded_wide_shape and myers_wide_stages pick
  the stages a band), K6's over the whole query (ops/hw_filter.wide_shape),
  under HW in segments too, a block each (`wide_segment_plan`). A pair
  taller than one band runs bands of stages, their top links by column in
  a scratch: K4's at once, a block each on a cluster, K5's and K6's one
  after the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..runtime.build import check, count_launch, library, stream_of
from . import banded
from .hw_filter import wide_shape

# csrc/myers_warp.cu and csrc/banded_warp.cu: kMaxR = 16 words (K4: band
# lanes) a lane, kWarps = 8 warps a block
WARP_MAX_WORDS = 32 * 16
WARPS_PER_BLOCK = 8
# K6's segment plan: the warps an SM runs before they slow each other's
# columns in proportion, sharing its issue. On the H100 one block (8 warps)
# an SM was the fastest of the segment counts banded_ab.py --sweep tried at
# 4 kbp x 1 Mbp; two blocks an SM took 1.7x as long.
SEG_WARPS_PER_SM = 8
# The wide route's plan: blocks an SM. A segment steps its S columns after
# a warm-up of 2 q_len, which past 16,384 rows outweighs S, so more
# segments add warm-up faster than they add pace. On the H100 (700 W;
# banded_ab.py --sweep, 17,000 bp x 1,048,576 bp, 96 stages a block) one
# block an SM (132 segments of 7,968 columns) took 14.4 ms, two 19.4, five
# 35.1, half a block an SM 17.3.
WIDE_BLOCKS_PER_SM = 1


def _warp_route(n: int, route: str) -> bool:
    """Whether a launch of n items a pair (K4's band lanes, K5's and K6's
    words) takes the warp route: "auto" while n <= WARP_MAX_WORDS; "warp"
    and "wide" force one (chip_smoke holds the routes against each other)."""
    if route not in ("auto", "warp", "wide"):
        raise ValueError(f"route must be 'auto', 'warp' or 'wide', got {route!r}")
    if route == "warp" and n > WARP_MAX_WORDS:
        raise ValueError(f"the warp route takes at most {WARP_MAX_WORDS} band lanes or words, "
                         f"got {n}")
    return route == "warp" or (route == "auto" and n <= WARP_MAX_WORDS)


def _split(P: int, Lq: int, Lt: int, units: int) -> tuple[int, int]:
    """(segments a pair, S): as many segments as fill `units` segment
    kernels (warps or blocks) on the card, S a multiple of 32, none unless
    S + 2 Lq < Lt."""
    n = min(units // max(P, 1), -(-Lt // 32))
    if n < 2:
        return 1, Lt
    S = -(-Lt // (32 * n)) * 32
    if S + 2 * Lq >= Lt:
        return 1, Lt
    return -(-Lt // S), S


def segment_plan(P: int, Lq: int, Lt: int, sms: int, resident: int) -> tuple[int, int]:
    """(segments a pair, columns a segment S) of K6's warp route under HW,
    for P pairs of queries padded to Lq against Lt target columns, on a card
    of `sms` SMs that holds `resident` warps of the kernel an SM. A pure
    function.

    Each segment is a warp that runs S + 2 Lq columns (its warm-up of up to
    2 q_len columns, then its own S), so the redundant work is (S + 2 Lq) /
    S. The card runs sms * min(SEG_WARPS_PER_SM, resident) warps at a
    column's own pace; past that the warps share the SMs' issue and the time
    grows with the total work. So the plan takes as many segments as fill
    those warps, with S a multiple of 32 (the kernel stores 32 end scores
    at once), and none (one warp a pair, no warm-up) unless S + 2 Lq < Lt."""
    return _split(P, Lq, Lt, sms * min(SEG_WARPS_PER_SM, resident))


def wide_segment_plan(P: int, Lq: int, Lt: int, sms: int, resident: int) -> tuple[int, int]:
    """(segments a pair, columns a segment S) of K6's wide route under HW, on
    a card of `sms` SMs that holds `resident` blocks of the wide kernel at
    Lq's stages an SM. A pure function of segment_plan's form: a segment is
    a block of wide_shape(Lq)'s stages (threads), and the plan takes
    WIDE_BLOCKS_PER_SM of them an SM, at most `resident`."""
    return _split(P, Lq, Lt, sms * min(resident, WIDE_BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def _card_warps(device_index: int, W: int) -> tuple[int, int]:
    """(SMs, resident warps an SM) for K6's warp kernel at W words, asked of
    the card: its SM count and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    at the kernel's registers."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(library().sd_semi_warp_occupancy(W, ctypes.byref(blocks)), "semi_warp occupancy")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms, blocks.value * WARPS_PER_BLOCK


@functools.lru_cache(maxsize=None)
def _card_blocks(device_index: int, stages: int) -> tuple[int, int]:
    """(SMs, resident blocks an SM) for K6's wide kernel at `stages` threads
    a block, asked of the card as _card_warps asks."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(library().sd_semi_wide_occupancy(stages, ctypes.byref(blocks)),
              "semi_wide occupancy")
    return torch.cuda.get_device_properties(device_index).multi_processor_count, blocks.value


def _checked(q, q_lens, t, t_lens):
    """int32, contiguous, all on q's device, [P, Lq] / [P] / [P, Lt] / [P]."""
    dev = q.device
    out = []
    for name, x in (("q", q), ("q_lens", q_lens), ("t", t), ("t_lens", t_lens)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {x.dtype}")
        out.append(x.contiguous())
    P = q.shape[0]
    if q.dim() != 2 or t.dim() != 2 or t.shape[0] != P or q_lens.shape != (P,) \
            or t_lens.shape != (P,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, q_lens {tuple(q_lens.shape)}, "
                         f"t {tuple(t.shape)}, t_lens {tuple(t_lens.shape)}")
    return out


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def banded_final_column_cuda(q, q_lens, t, t_lens, *, k: int, use_mask: bool = False,
                             route: str = "auto"):
    """K4: [P, 2k+1] int32, as ops/banded.banded_final_column. `route`:
    "auto" (the warp route while 2k + 1 <= WARP_MAX_WORDS band lanes, k <=
    255, else the wide one), "warp" or "wide"."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    Bw = 2 * k + 1
    warp = _warp_route(Bw, route)
    if not q.is_cuda:
        return banded.banded_final_column(q, q_lens, t, t_lens, k=k, use_mask=use_mask)
    q, q_lens, t, t_lens = _checked(q, q_lens, t, t_lens)
    (P, Lq), Lt = q.shape, t.shape[1]
    out = torch.empty((P, Bw), dtype=torch.int32, device=q.device)
    if P == 0:
        return out
    if warp:
        check(library().sd_banded_warp(
            q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(), out.data_ptr(),
            P, Lq, Lt, k, int(use_mask), stream_of(q),
        ), "banded_final_column warp kernel")
        count_launch(banded_final_column_cuda)
        return out
    stages, seams, cs = banded.banded_wide_shape(Lq, Lt, k)
    tops = prog = None
    if seams:  # a pair may pass one band: the bands' top links and their progress
        tops = torch.empty((P, seams, Bw), dtype=torch.int32, device=q.device)
        prog = torch.zeros((P, seams), dtype=torch.int32, device=q.device)
    check(library().sd_banded_column(
        q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(), _ptr(tops), _ptr(prog),
        out.data_ptr(), P, Lq, Lt, k, int(use_mask), stages, seams, cs, stream_of(q),
    ), "banded_final_column wide kernel")
    count_launch(banded_final_column_cuda, "launches_wide")
    return out


def banded_myers_cuda(q, q_lens, t, t_lens, *, k: int, route: str = "auto"):
    """K5: [P, 2k+1] int32, as ops/banded.banded_final_column_myers (bit-equal
    on every lane). The kernel emits the captured planes and anchor; the
    column is rebuilt by a cumsum on the device, as the JAX package does
    outside its kernel. `route`: "auto" (the warp route while W <=
    WARP_MAX_WORDS, else the wide one), "warp" or "wide"."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    W = -(-(2 * k + 1) // 32)
    warp = _warp_route(W, route)
    if not q.is_cuda:
        return banded.banded_final_column_myers(q, q_lens, t, t_lens, k=k)
    q, q_lens, t, t_lens = _checked(q, q_lens, t, t_lens)
    (P, Lq), Lt = q.shape, t.shape[1]
    dev = q.device
    cvp = torch.empty((P, W), dtype=torch.int32, device=dev)
    cvn = torch.empty((P, W), dtype=torch.int32, device=dev)
    ca = torch.empty((P,), dtype=torch.int32, device=dev)
    if P and warp:
        # the query's per-code bitmaps over bits p = query index + k + 1
        NB = (k + Lq + 32) // 32 + 1
        bm = torch.empty((P, 4, NB), dtype=torch.int32, device=dev)
        check(library().sd_myers_warp(
            q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(), bm.data_ptr(),
            cvp.data_ptr(), cvn.data_ptr(), ca.data_ptr(), P, Lq, Lt, k, W, NB, stream_of(q),
        ), "banded_myers warp kernel")
        count_launch(banded_myers_cuda)
    elif P:
        stages, tall = banded.myers_wide_stages(Lq, Lt, k)
        tops = torch.empty((P, Lt + 1), dtype=torch.uint8, device=dev) if tall else None
        check(library().sd_banded_myers(
            q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(), _ptr(tops),
            cvp.data_ptr(), cvn.data_ptr(), ca.data_ptr(), P, Lq, Lt, k, W, stages, stream_of(q),
        ), "banded_myers wide kernel")
        count_launch(banded_myers_cuda, "launches_wide")
    return banded.reconstruct_myers_column(banded.as_uint32(cvp), banded.as_uint32(cvn), ca,
                                           q_lens, t_lens, k)


def semi_ends_cuda(q, q_lens, t, t_lens, *, free_target_prefix: bool = True,
                   route: str = "auto", seg_cols: int | None = None):
    """K6: [P, Lt] int32, as ops/banded.semi_ends_myers. `route` as in
    banded_myers_cuda. Under HW, `seg_cols` sets the columns a segment (a
    multiple of 32; 0: one warp or block a pair), else `segment_plan` (the
    warp route) or `wide_segment_plan` (the wide one) picks them from the
    card; SHW takes no segments."""
    W = max(1, -(-q.shape[1] // 32))
    warp = _warp_route(W, route)
    if seg_cols is not None and (not free_target_prefix or seg_cols < 0 or seg_cols % 32):
        raise ValueError(f"seg_cols={seg_cols}: segments are for HW, a multiple of 32 columns "
                         "(0: none)")
    if not q.is_cuda:
        return banded.semi_ends_myers(q, q_lens, t, t_lens, free_target_prefix=free_target_prefix)
    q, q_lens, t, t_lens = _checked(q, q_lens, t, t_lens)
    (P, Lq), Lt = q.shape, t.shape[1]
    ends = torch.empty((P, Lt), dtype=torch.int32, device=q.device)
    if P == 0 or Lt == 0:
        return ends
    stages, bands = wide_shape(Lq)  # the wide route's
    nseg, S = 1, Lt
    if seg_cols:
        nseg, S = -(-Lt // seg_cols), seg_cols
    elif seg_cols is None and free_target_prefix:
        dev = q.device.index
        nseg, S = (segment_plan(P, Lq, Lt, *_card_warps(dev, W)) if warp else
                   wide_segment_plan(P, Lq, Lt, *_card_blocks(dev, stages)))
    hp0 = 0 if free_target_prefix else 1
    if warp:
        bm = torch.empty((P, 4, W), dtype=torch.int32, device=q.device)
        check(library().sd_semi_warp(
            q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), bm.data_ptr(), ends.data_ptr(),
            P, Lq, Lt, W, hp0, nseg, S, stream_of(q),
        ), "semi_ends warp kernel")
        count_launch(semi_ends_cuda)
        return ends
    # past one band, each band's top links: a byte a column of a segment and
    # its warm-up
    ncap = min(Lt, S + 64 * W)
    tops = torch.empty((P * nseg, ncap), dtype=torch.uint8, device=q.device) if bands > 1 else None
    check(library().sd_semi_wide(
        q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), _ptr(tops), ends.data_ptr(),
        P, Lq, Lt, W, stages, bands, hp0, nseg, S, ncap, stream_of(q),
    ), "semi_ends wide kernel")
    count_launch(semi_ends_cuda, "launches_wide")
    return ends


banded_final_column_cuda.launches = 0
banded_final_column_cuda.launches_wide = 0
banded_myers_cuda.launches = 0
banded_myers_cuda.launches_wide = 0
semi_ends_cuda.launches = 0
semi_ends_cuda.launches_wide = 0
