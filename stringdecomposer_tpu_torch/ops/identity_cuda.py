"""K2 on the card: NW identity (csrc/nw_identity.cu), a warp per pair with
the DP column in registers.

Two wrappers over the one kernel, each dispatching on the device of `q`: a
CPU tensor runs the plain twin, a CUDA tensor launches the kernel (exact at
any length) or raises.
- `nw_identity_batch_cuda` (contract of ops/identity.nw_identity_batch):
  pair p is q row p against t row p. Light mode scores its pairs with it.
- `nw_identity_cross_cuda` (contract of ops/identity.nw_identity_cross):
  every q row against every t row, with no expanded copies. The packed
  finishing entry point runs its prologue in torch on the same device and
  scores both variants through it.
"""

from __future__ import annotations

import torch

from ..runtime.build import check, count_launch, library, stream_of
from . import identity as plain

# csrc/nw_identity.cu: kMaxC rows a lane (a strip is 32 * C_MAX query rows)
C_MAX = 16


def cells_per_lane(Lq: int) -> int:
    """The kernel's C for queries padded to Lq: ceil(Lq / 32), at least 1,
    at most C_MAX (longer queries run in strips of 32 * C_MAX rows)."""
    return min(max(1, -(-Lq // 32)), C_MAX)


def carry_scratch(P: int, Lq: int, Lt: int, dev) -> torch.Tensor | None:
    """The strip route's carry rows, [P, 2, Lt + 1] int2 in device memory,
    where queries padded to Lq exceed one strip; None (one strip, no carry)
    otherwise."""
    if Lq <= 32 * C_MAX:
        return None
    return torch.empty((P, 2, Lt + 1, 2), dtype=torch.int32, device=dev)


def _on_card(q, q_lens, t, t_lens):
    """int32 contiguous copies (no copy where they are already so), checked
    to share q's device."""
    dev = q.device
    for name, x in (("q_lens", q_lens), ("t", t), ("t_lens", t_lens)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if q.dim() != 2 or t.dim() != 2:
        raise ValueError(f"q {tuple(q.shape)} and t {tuple(t.shape)} must be 2-D")
    if q_lens.shape != (q.shape[0],) or t_lens.shape != (t.shape[0],):
        raise ValueError(f"lens {tuple(q_lens.shape)} / {tuple(t_lens.shape)} for q "
                         f"{tuple(q.shape)}, t {tuple(t.shape)}")
    return [x.to(torch.int32).contiguous() for x in (q, q_lens, t, t_lens)]


def _ptr(x):
    return None if x is None else x.data_ptr()


def nw_identity_batch_cuda(q, q_lens, t, t_lens):
    """(dist[P], matches[P], columns[P]) int32, as ops/identity.nw_identity_batch.
    Lengths must lie within the padded widths (the kernel clamps to them)."""
    if not q.is_cuda:
        return plain.nw_identity_batch(q, q_lens, t, t_lens)
    if t.shape[0] != q.shape[0]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, t {tuple(t.shape)}")
    qc, ql, tc, tl = _on_card(q, q_lens, t, t_lens)
    P, Lq = qc.shape
    Lt = tc.shape[1]
    out = torch.empty((3, P), dtype=torch.int32, device=q.device)
    if P > 0:
        carry = carry_scratch(P, Lq, Lt, q.device)
        check(library().sd_nw_identity(
            qc.data_ptr(), ql.data_ptr(), tc.data_ptr(), tl.data_ptr(), _ptr(carry),
            out.data_ptr(), P, Lq, Lt, stream_of(q),
        ), "nw_identity kernel")
        count_launch(nw_identity_batch_cuda)
    return out[0], out[1], out[2]


nw_identity_batch_cuda.launches = 0


def nw_identity_cross_cuda(q, q_lens, t, t_lens):
    """[Nb, M, 2] int32 (D, columns) of every q row against every t row, as
    ops/identity.nw_identity_cross; matches = columns - D."""
    if not q.is_cuda:
        return plain.nw_identity_cross(q, q_lens, t, t_lens)
    qc, ql, tc, tl = _on_card(q, q_lens, t, t_lens)
    (Nb, Lq), (M, Lt) = qc.shape, tc.shape
    out = torch.empty((Nb, M, 2), dtype=torch.int32, device=q.device)
    if Nb * M > 0:
        carry = carry_scratch(Nb * M, Lq, Lt, q.device)
        check(library().sd_nw_identity_cross(
            qc.data_ptr(), ql.data_ptr(), tc.data_ptr(), tl.data_ptr(), _ptr(carry),
            out.data_ptr(), Nb, M, Lq, Lt, stream_of(q),
        ), "nw_identity_cross kernel")
        count_launch(nw_identity_cross_cuda)
    return out


nw_identity_cross_cuda.launches = 0


def nw_identity_packed_both(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo, n_pad, Lq):
    """Device-side finishing dispatch (contract of the JAX package's
    identity_pallas.nw_identity_packed_both): extracts the blocks from the
    resident read, collapses homopolymers, scores every (block, monomer)
    pair of both variants with the cross entry and returns [2, n_pad * M, 2]
    int32 (D, columns); matches = columns - D. Values are int32, so any
    block length is exact."""
    return plain.packed_both(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo,
                             n_pad, Lq, nw_identity_cross_cuda)
