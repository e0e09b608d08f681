"""K3 on the card: the HW distance of the --ed_thr pre-filter
(csrc/hw_filter.cu), bit-parallel Myers.

`hw_distance_batch_cuda` has the contract of ops/hw_filter.hw_distance_batch
and dispatches on the device of `windows`: a CPU tensor runs the plain
PyTorch twin, a CUDA tensor launches the kernel (exact at any monomer
length) and raises on anything it does not take. It has three routes, by
the monomers' padded length L (ops/hw_filter.hw_route), each with its own
launch counter:
- the thread route (`launches`; L <= 512), one thread per (window,
  monomer, target segment), R = ceil(L / 32) words in registers;
- the warp route (`launches_warp`; L <= 16,384), one warp per (window,
  monomer, target segment), the words over its lanes (K6's warp column);
- the wide route (`launches_wide`; any L), one block per pair, its column
  over the block's threads in stages of 8 words, run as a pipeline.
`hw_segment_plan` cuts the windows into segments so that the card is full.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..runtime.build import check, count_launch, library, stream_of
from . import hw_filter as plain
from .banded_cuda import SEG_WARPS_PER_SM

_ROUTE_ID = {"thread": 0, "warp": 1, "wide": 2}
_COUNTER = {"thread": "launches", "warp": "launches_warp", "wide": "launches_wide"}
# csrc/hw_filter.cu: kThreads threads a thread-route block, kWarps warps a
# warp-route block
THREADS_PER_BLOCK = 64
WARPS_PER_BLOCK = 8
# hw_segment_plan: the threads (thread route) or warps (warp route) whose
# column chains one SM overlaps at its issue rate. On the H100 (700 W) a
# lone thread-route column took 125 ns (R = 6: one segment a pair, 38
# threads an SM) and a full SM ran 1.36 G columns/s, so ~170 threads' chains
# fill its issue (the seg_cols sweep at the golden windows x DXZ1 and x the
# library and 64 windows x the library); the warp route takes K6's 8 warps
# an SM (SEG_WARPS_PER_SM).
SEG_THREADS_PER_SM = 170


def hw_segment_plan(P: int, L: int, W: int, sms: int, resident: int,
                    per_sm: int) -> tuple[int, int]:
    """(segments a pair, columns a segment S) of K3 for P (window, monomer)
    pairs of monomers padded to L against windows W columns wide, on a card
    of `sms` SMs that holds `resident` units (threads or warps) of the
    route's kernel an SM, `per_sm` of whose column chains an SM overlaps. A
    pure function.

    A segment is a unit that runs up to 2 L warm-up columns and then its S
    columns (S a multiple of 16: the thread route reads 16 chars at once).
    In columns of one unit's chain, n segments a pair take about
        P (W + (n - 1) 2 L) / (sms min(per_sm, resident))    (the card's issue)
      + S + 2 L                                              (one chain)
    (W for one segment, which has no warm-up). The first term grows by
    a = 2 L P / units a segment, the second falls as W / n, so the plan tries
    n = 1 and the n next to sqrt(W / a) and keeps the cheapest."""
    one = (1, max(16, -(-W // 16) * 16))
    units = sms * max(1, min(per_sm, resident))
    if P <= 0 or W <= 32 or L <= 0:
        return one

    def cost(n: int) -> tuple[float, tuple[int, int]]:
        S = -(-W // (16 * n)) * 16
        nseg = -(-W // S)
        if nseg == 1:
            return P * W / units + W, one
        return P * (W + (nseg - 1) * 2 * L) / units + S + 2 * L, (nseg, S)

    most = -(-W // 16)
    n0 = min(most, max(1, round(math.sqrt(W * units / (2 * L * P)))))
    cands = {1} | {n for n in (n0 - 1, n0, n0 + 1) if 1 <= n <= most}
    return min((cost(n) for n in sorted(cands)), key=lambda c: c[0])[1]


@functools.lru_cache(maxsize=None)
def _card_units(device_index: int, route: str, L: int) -> tuple[int, int]:
    """(SMs, resident threads or warps an SM) for a K3 route's kernel at
    monomers padded to L, asked of the card: its SM count and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor at the kernel's registers."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(library().sd_hw_occupancy(_ROUTE_ID[route], L, ctypes.byref(blocks)),
              "hw_distance occupancy")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    per_block = THREADS_PER_BLOCK if route == "thread" else WARPS_PER_BLOCK
    return sms, blocks.value * per_block


@functools.lru_cache(maxsize=None)
def plan(B: int, M: int, L: int, W: int, device_index: int, route: str = "auto"):
    """(route, segments a pair, S) that hw_distance_batch_cuda takes for B
    windows W wide x M monomers padded to L on the card."""
    route = plain.hw_route(L, route)
    if route == "wide":
        return route, 1, max(16, -(-W // 16) * 16)
    per_sm = SEG_THREADS_PER_SM if route == "thread" else SEG_WARPS_PER_SM
    return (route, *hw_segment_plan(B * M, L, W, *_card_units(device_index, route, L), per_sm))


def hw_distance_batch_cuda(windows, window_lens, mono, mono_lens, *, route: str = "auto",
                           seg_cols: int | None = None):
    """dist[B, M] int32, as ops/hw_filter.hw_distance_batch: codes match
    equal codes. Codes 0-4 (io/fasta.encode's A, C, G, T, N) take the fast
    path; a monomer or window code outside 0-4 is compared all the same, on
    a slower one. `route`: "auto" (by L, ops/hw_filter.hw_route), "thread",
    "warp" or "wide". `seg_cols` sets the columns a
    segment on the thread and warp routes (a multiple of 16; 0: one a
    pair); else hw_segment_plan picks them from the card."""
    route = plain.hw_route(mono.shape[-1], route)
    if seg_cols is not None and (seg_cols < 0 or seg_cols % 16 or (route == "wide" and seg_cols)):
        raise ValueError(f"seg_cols={seg_cols}: segments are a multiple of 16 columns (0: one "
                         "a pair), on the thread and warp routes")
    if not windows.is_cuda:
        return plain.hw_distance_batch(windows, window_lens, mono, mono_lens)
    B, W = windows.shape
    dev = windows.device
    for name, x, dt in (("windows", windows, torch.int8), ("window_lens", window_lens, torch.int32),
                        ("mono", mono, torch.int8), ("mono_lens", mono_lens, torch.int32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, windows on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {x.dtype}")
    if mono.dim() != 2 or window_lens.shape != (B,) or mono_lens.shape != (mono.shape[0],):
        raise ValueError(f"shape mismatch: windows {tuple(windows.shape)}, window_lens "
                         f"{tuple(window_lens.shape)}, mono {tuple(mono.shape)}, mono_lens "
                         f"{tuple(mono_lens.shape)}")
    M, L = mono.shape
    if seg_cols is not None:
        nseg, S = plain.segments(W, seg_cols)
    else:
        card = torch.cuda.current_device() if dev.index is None else dev.index
        _, nseg, S = plan(B, M, L, W, card, route)
    if B == 0 or M == 0:
        return torch.empty((B, M), dtype=torch.int32, device=dev)
    # the thread route reads 16 chars at once: rows of a multiple of 16
    # bytes, 16-byte aligned
    windows = windows.contiguous()
    Wp = -(-W // 16) * 16
    if Wp != W or windows.data_ptr() % 16:
        windows = F.pad(windows, (0, Wp - W))
    window_lens, mono, mono_lens = (x.contiguous() for x in (window_lens, mono, mono_lens))
    if nseg == 1:
        out = torch.empty((B, M), dtype=torch.int32, device=dev)
    else:  # the segments' minima land by atomicMin
        out = torch.full((B, M), plain.BIG, dtype=torch.int32, device=dev)
    peq = top = None
    if route == "wide":  # the entry takes its bands and stages as nseg and S
        stages, bands = plain.wide_shape(L)
        nseg, S = bands, stages
        peq = torch.empty((M, 5, bands * stages * plain.WIDE_R), dtype=torch.int32, device=dev)
        if bands > 1:  # each band's top link a column, for the next band
            top = torch.empty((B * M, Wp), dtype=torch.uint8, device=dev)
    check(library().sd_hw_distance(
        _ROUTE_ID[route], windows.data_ptr(), window_lens.data_ptr(), mono.data_ptr(),
        mono_lens.data_ptr(), None if peq is None else peq.data_ptr(),
        None if top is None else top.data_ptr(), out.data_ptr(), B, W, Wp, M, L, nseg, S,
        stream_of(windows),
    ), f"hw_distance {route} kernel")
    count_launch(hw_distance_batch_cuda, _COUNTER[route])
    return out


hw_distance_batch_cuda.launches = 0
hw_distance_batch_cuda.launches_warp = 0
hw_distance_batch_cuda.launches_wide = 0
