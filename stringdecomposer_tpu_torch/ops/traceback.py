"""Host-side assembly of device-emitted block records; the port's copy of
the JAX package's ops/traceback.py.

The backward traceback of the reference (src/main.cpp:217-269) is fully
replaced by the forward start-pointer propagation + on-device block walk in
ops/chain_dp_cuda.py; what reaches the host is one compact int32 record per block:
(monomer_idx, start, end, identity), emitted end-of-window first. This module
just reverses them into reading order and wraps them as Block objects.
"""

from __future__ import annotations

import numpy as np

from .oracle import Block


def blocks_from_device(blocks_arr: np.ndarray, count: int) -> list[Block]:
    """blocks_arr: [max_blocks, 4] int32 (monomer, start, end, identity),
    first `count` entries valid, ordered last-block-first."""
    out = [
        Block(int(m), int(s), int(e), float(ident))
        for m, s, e, ident in np.asarray(blocks_arr[:count][::-1])
    ]
    return out
