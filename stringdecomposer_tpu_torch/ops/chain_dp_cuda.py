"""K1 on the card: chain DP (csrc/chain_dp.cu) and the block-walk kernel.

`chain_dp_forward_cuda` has the contract of ops/chain_dp.chain_dp_forward.
It dispatches on the device of `windows`: a CPU tensor runs the plain
PyTorch twin, a CUDA tensor launches the kernels (and raises on anything
they do not take). Only the [B, max_blocks, 4] block records and the [B]
counts are meant to leave the device.
"""

from __future__ import annotations

import torch

from ..runtime.build import check, count_launch, library, stream_of
from . import chain_dp as plain

# Opt-in dynamic shared memory of one thread block on the H100 (sm_90).
SMEM_LIMIT = 232_448


def smem_bytes(M: int, L: int) -> int:
    """Shared memory K1 needs for one window: scores and start pointers
    (int32), monomer codes (int8) per cell, plus two int32 per row (the
    kernel's launch computes the same, csrc/chain_dp.cu)."""
    return (2 * M * L + 2 * M) * 4 + M * L


def check_monomer_set(M: int, L: int) -> None:
    if smem_bytes(M, L) > SMEM_LIMIT:
        raise ValueError(
            f"monomer set too large for the chain-DP kernel: M={M} monomers "
            f"padded to L={L} need {smem_bytes(M, L)} bytes of shared memory "
            f"per window, above the {SMEM_LIMIT}-byte limit of one block "
            f"(9 * M * L + 8 * M <= {SMEM_LIMIT})"
        )


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


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
):
    """Same contract and outputs as ops/chain_dp.chain_dp_forward."""
    if not windows.is_cuda:
        return plain.chain_dp_forward(
            windows, window_lens, mono, mono_lens, ins=ins, dele=dele,
            mismatch=mismatch, match=match, max_blocks=max_blocks,
            return_debug=return_debug,
        )
    B, W = windows.shape
    if max_blocks == 0:
        max_blocks = W
    M, L = mono.shape[-2], mono.shape[-1]
    dev = windows.device
    for name, x, dt in (("windows", windows, torch.int8), ("window_lens", window_lens, torch.int32),
                        ("mono", mono, torch.int8), ("mono_lens", mono_lens, torch.int32)):
        _require(x.device == dev, f"{name} is on {x.device}, windows on {dev}")
        _require(x.dtype == dt, f"{name} must be {dt}, got {x.dtype}")
    _require(mono.dim() in (2, 3) and mono_lens.dim() == mono.dim() - 1,
             "mono must be [M, L] or [B, M, L] with lens [M] or [B, M]")
    _require(mono.dim() == 2 or mono.shape[0] == B, "per-window mono needs B rows")
    _require(M >= 1 and L >= 1 and W >= 1, "empty monomer set or window")
    check_monomer_set(M, L)
    windows = windows.contiguous()
    mono = mono.contiguous()
    mono_lens = mono_lens.contiguous()
    mono_b, lens_b = plain.broadcast_monomers(mono, mono_lens, B)
    dp0 = plain.init_column(windows, mono_b, lens_b, dele, mismatch, match).contiguous()
    end = torch.empty((B, W, M), dtype=torch.int32, device=dev)
    spend = torch.empty_like(end)
    per_window = mono.dim() == 3
    if B > 0:
        lib = library()
        check(lib.sd_chain_dp(
            windows.data_ptr(), mono.data_ptr(), M * L if per_window else 0,
            mono_lens.data_ptr(), M if per_window else 0, dp0.data_ptr(),
            end.data_ptr(), spend.data_ptr(), B, W, M, L,
            ins, dele, mismatch, match, stream_of(windows),
        ), "chain_dp kernel")
        count_launch(chain_dp_forward_cuda)
    blocks, counts = block_walk_cuda(end, spend, window_lens, max_blocks)
    if return_debug:
        head = torch.full((B, 1), plain.INF, dtype=torch.int32, device=dev)
        chain = torch.cat([head, end[:, :-1].amax(dim=2)], dim=1)
        return blocks, counts, (chain, end, spend)
    return blocks, counts


chain_dp_forward_cuda.launches = 0


def block_walk_cuda(end, spend, window_lens, max_blocks: int):
    """Same contract as ops/chain_dp.block_walk; one thread per window."""
    if not end.is_cuda:
        return plain.block_walk(end, spend, window_lens, max_blocks)
    B, W, M = end.shape
    for name, x in (("end", end), ("spend", spend), ("window_lens", window_lens)):
        _require(x.device == end.device and x.dtype == torch.int32,
                 f"{name} must be int32 on {end.device}")
    _require(spend.shape == end.shape and window_lens.shape == (B,), "shape mismatch")
    end, spend, window_lens = end.contiguous(), spend.contiguous(), window_lens.contiguous()
    blocks = torch.zeros((B, max_blocks, 4), dtype=torch.int32, device=end.device)
    counts = torch.empty((B,), dtype=torch.int32, device=end.device)
    if B > 0:
        check(library().sd_block_walk(
            end.data_ptr(), spend.data_ptr(), window_lens.data_ptr(),
            blocks.data_ptr(), counts.data_ptr(), B, W, M, max_blocks,
            stream_of(end),
        ), "block_walk kernel")
        count_launch(block_walk_cuda)
    return blocks, counts


block_walk_cuda.launches = 0
