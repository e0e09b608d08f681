"""K3 on the card: the HW distance of the --ed_thr pre-filter
(csrc/hw_filter.cu).

`hw_distance_batch_cuda` has the contract of ops/hw_filter.hw_distance_batch
and dispatches on the device of `windows`: a CPU tensor runs the plain
PyTorch twin, a CUDA tensor launches the kernel (exact at any monomer
length) and raises on anything it does not take.
"""

from __future__ import annotations

import torch

from ..runtime.build import check, count_launch, library, stream_of
from . import hw_filter as plain

# Columns of up to this many cells (monomers up to 255 bp) stay in registers;
# longer ones stream through a device-memory scratch in segments of this size.
REGISTER_CELLS = 256


def hw_distance_batch_cuda(windows, window_lens, mono, mono_lens):
    """dist[B, M] int32, as ops/hw_filter.hw_distance_batch."""
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
    out = torch.empty((B, M), dtype=torch.int32, device=dev)
    if B == 0 or M == 0:
        return out
    seg_cells, scratch = 0, None  # the register route needs no scratch
    if L + 1 > REGISTER_CELLS:
        seg_cells = -(-(L + 1) // REGISTER_CELLS) * REGISTER_CELLS
        scratch = torch.empty((B * M, seg_cells), dtype=torch.int32, device=dev)
    windows, window_lens = windows.contiguous(), window_lens.contiguous()
    mono, mono_lens = mono.contiguous(), mono_lens.contiguous()
    check(library().sd_hw_distance(
        windows.data_ptr(), window_lens.data_ptr(), mono.data_ptr(), mono_lens.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(), B, W, M, L, seg_cells,
        stream_of(windows),
    ), "hw_distance kernel")
    count_launch(hw_distance_batch_cuda)
    return out


hw_distance_batch_cuda.launches = 0
