"""K2 on the card: NW identity (csrc/nw_identity.cu).

`nw_identity_batch_cuda` has the contract of ops/identity.nw_identity_batch
and dispatches on the device of `q`: a CPU tensor runs the plain twin, a
CUDA tensor launches the kernel (exact at any length). The packed finishing
entry point runs its prologue in torch on the same device and scores the
pairs through it.
"""

from __future__ import annotations

import torch

from ..runtime.build import check, count_launch, library, stream_of
from . import identity as plain


def nw_identity_batch_cuda(q, q_lens, t, t_lens):
    """(dist[P], matches[P], columns[P]) int32, as ops/identity.nw_identity_batch.
    Lengths must lie within the padded widths (the kernel clamps to them)."""
    if not q.is_cuda:
        return plain.nw_identity_batch(q, q_lens, t, t_lens)
    P, Lq = q.shape
    Lt = t.shape[1]
    dev = q.device
    for name, x in (("q_lens", q_lens), ("t", t), ("t_lens", t_lens)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, q on {dev}")
    if t.shape[0] != P or q_lens.shape != (P,) or t_lens.shape != (P,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, t {tuple(t.shape)}, "
                         f"lens {tuple(q_lens.shape)} / {tuple(t_lens.shape)}")
    qT = q.to(torch.int32).t().contiguous()  # [Lq, P]: a warp reads 32 pairs at once
    tc = t.to(torch.int32).contiguous()
    ql = q_lens.to(torch.int32).contiguous()
    tl = t_lens.to(torch.int32).contiguous()
    col = torch.empty((max(Lq, 1), P, 2), dtype=torch.int32, device=dev)
    out = torch.empty((3, P), dtype=torch.int32, device=dev)
    if P > 0:
        check(library().sd_nw_identity(
            qT.data_ptr(), ql.data_ptr(), tc.data_ptr(), tl.data_ptr(),
            col.data_ptr(), out.data_ptr(), P, Lq, Lt, stream_of(q),
        ), "nw_identity kernel")
        count_launch(nw_identity_batch_cuda)
    return out[0], out[1], out[2]


nw_identity_batch_cuda.launches = 0


def nw_identity_packed_both(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo, n_pad, Lq):
    """Device-side finishing dispatch (contract of the JAX package's
    identity_pallas.nw_identity_packed_both): extracts the blocks from the
    resident read, collapses homopolymers, expands (block x monomer) for both
    variants and returns [2, n_pad * M, 2] int32 (D, columns);
    matches = columns - D. Values are int32, so any block length is exact."""
    return plain.packed_both(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo,
                             n_pad, Lq, nw_identity_batch_cuda)
