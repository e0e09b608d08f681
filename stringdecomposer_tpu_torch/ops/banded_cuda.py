"""K4, K5 and K6 on the card: the banded and semi-global sweeps of the
alignment API (csrc/banded.cu).

Each wrapper has the contract of its twin in ops/banded.py and dispatches
on the device of `q`: a CPU tensor runs the twin, a CUDA tensor launches the
kernel (exact at any band width and query length) and raises on anything it
does not take. The block size and the items per thread are chosen here;
the band's arrays sit in shared memory while they fit and in a per-pair
device-memory scratch beyond that.
"""

from __future__ import annotations

import torch

from ..runtime.build import check, count_launch, library, stream_of
from . import banded

# dynamic shared memory one block may opt into on the H100 (sm_90)
SMEM_BYTES = 232_448
_SLOTS = 32  # the kernels' scan slots, one int per warp
_PLANE_ARRAYS = 9  # K5 / K6: VP, VN, four Peq planes, d0, HP, HN


def _layout(n: int) -> tuple[int, int]:
    """(threads, items per thread) for n band lanes or words: one item per
    thread up to 1024 threads, then R consecutive items each."""
    T = min(1024, max(32, -(-n // 32) * 32))
    return T, max(1, -(-n // T))


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


def _scratch(P: int, words: int, dev):
    """None when `words` int32 per block fit shared memory, else a per-pair
    device-memory scratch."""
    if (_SLOTS + words) * 4 <= SMEM_BYTES:
        return None
    return torch.empty((P, words), dtype=torch.int32, device=dev)


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def banded_final_column_cuda(q, q_lens, t, t_lens, *, k: int, use_mask: bool = False):
    """K4: [P, 2k+1] int32, as ops/banded.banded_final_column."""
    if not q.is_cuda:
        return banded.banded_final_column(q, q_lens, t, t_lens, k=k, use_mask=use_mask)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    q, q_lens, t, t_lens = _checked(q, q_lens, t, t_lens)
    (P, Lq), Lt, Bw = q.shape, t.shape[1], 2 * k + 1
    T, R = _layout(Bw)
    out = torch.empty((P, Bw), dtype=torch.int32, device=q.device)
    if P == 0:
        return out
    scratch = _scratch(P, R * T, q.device)
    check(library().sd_banded_column(
        q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(), _ptr(scratch),
        out.data_ptr(), P, Lq, Lt, k, int(use_mask), T, R, stream_of(q),
    ), "banded_final_column kernel")
    count_launch(banded_final_column_cuda)
    return out


def banded_myers_cuda(q, q_lens, t, t_lens, *, k: int):
    """K5: [P, 2k+1] int32, as ops/banded.banded_final_column_myers (bit-equal
    on every lane). The kernel emits the captured planes and anchor; the
    column is rebuilt by a cumsum on the device, as the JAX package does
    outside its kernel."""
    if not q.is_cuda:
        return banded.banded_final_column_myers(q, q_lens, t, t_lens, k=k)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    q, q_lens, t, t_lens = _checked(q, q_lens, t, t_lens)
    (P, Lq), Lt = q.shape, t.shape[1]
    W = -(-(2 * k + 1) // 32)
    T, R = _layout(W)
    dev = q.device
    cvp = torch.empty((P, W), dtype=torch.int32, device=dev)
    cvn = torch.empty((P, W), dtype=torch.int32, device=dev)
    ca = torch.empty((P,), dtype=torch.int32, device=dev)
    if P:
        scratch = _scratch(P, _PLANE_ARRAYS * R * T, dev)
        check(library().sd_banded_myers(
            q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), t_lens.data_ptr(), _ptr(scratch),
            cvp.data_ptr(), cvn.data_ptr(), ca.data_ptr(), P, Lq, Lt, k, W, T, R, stream_of(q),
        ), "banded_myers kernel")
        count_launch(banded_myers_cuda)
    return banded.reconstruct_myers_column(banded.as_uint32(cvp), banded.as_uint32(cvn), ca,
                                           q_lens, t_lens, k)


def semi_ends_cuda(q, q_lens, t, t_lens, *, free_target_prefix: bool = True):
    """K6: [P, Lt] int32, as ops/banded.semi_ends_myers."""
    if not q.is_cuda:
        return banded.semi_ends_myers(q, q_lens, t, t_lens, free_target_prefix=free_target_prefix)
    q, q_lens, t, t_lens = _checked(q, q_lens, t, t_lens)
    (P, Lq), Lt = q.shape, t.shape[1]
    W = max(1, -(-Lq // 32))
    T, R = _layout(W)
    ends = torch.empty((P, Lt), dtype=torch.int32, device=q.device)
    if P == 0 or Lt == 0:
        return ends
    scratch = _scratch(P, _PLANE_ARRAYS * R * T, q.device)
    check(library().sd_semi_ends(
        q.data_ptr(), q_lens.data_ptr(), t.data_ptr(), _ptr(scratch), ends.data_ptr(),
        P, Lq, Lt, W, T, R, 0 if free_target_prefix else 1, stream_of(q),
    ), "semi_ends kernel")
    count_launch(semi_ends_cuda)
    return ends


banded_final_column_cuda.launches = 0
banded_myers_cuda.launches = 0
semi_ends_cuda.launches = 0
