"""Data-parallel execution over a list of devices, ported from
stringdecomposer_tpu/parallel/sharding.py.

The JAX package shard_maps each function over a 1-D mesh. Here each
function splits its batch into contiguous equal shards, runs the same
hand-written kernel on each shard under its device's guard (every C entry
launches on the current device, on that device's current stream), and
brings the outputs back to the caller's device in shard order. No shard
talks to another, and nothing waits on the host: a cross-device copy is
ordered on both devices' current streams, so the caller's events (the DP
stream's in-flight batches) still say when the results are ready.

Each function's per-shard program defaults by the shard's device type:
the kernel wrapper on a GPU, the plain twin on the CPU. A repeated device
list (["cpu"] * 4, [cuda:0] * 3) runs several shards on one device, which
is how the tests and chip_smoke.py check that the bytes do not depend on
the shard count.
"""

from __future__ import annotations

import threading
from contextlib import nullcontext

import numpy as np
import torch

from ..ops import chain_dp as k1_plain
from ..ops import identity as k2_plain
from ..ops.chain_dp_cuda import chain_dp_forward_cuda
from ..ops.identity_cuda import nw_identity_batch_cuda, nw_identity_packed_both
from .mesh import get_devices


def device_guard(device: torch.device):
    """Makes `device` the current CUDA device (a no-op on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _resolve(devices) -> list[torch.device]:
    """The shards' devices, each with its index ("cuda" is the current GPU)."""
    if devices is None:
        return get_devices("cuda")
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("no devices to shard over")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with its last row repeated n more times on the leading axis."""
    return x if n == 0 else torch.cat([x, x[-1:].expand(n, *x.shape[1:])])


class _Replicas:
    """Copies of a caller's tensors on each shard's device, kept while the
    caller hands in the same tensor again (the monomer set of a run, the
    resident read of a finishing group). The finisher's worker threads
    share them, so the table is locked."""

    def __init__(self):
        self._held: dict = {}
        self._lock = threading.Lock()

    def on(self, slot: str, x: torch.Tensor, device: torch.device) -> torch.Tensor:
        if x.device == device:
            return x
        with self._lock:
            held = self._held.get((slot, device))
            if held is None or held[0] is not x:
                held = self._held[slot, device] = (x, x.to(device, non_blocking=True))
            return held[1]


def make_sharded_forward(devices=None, inner_fn=None):
    """A forward_fn with chain_dp_forward_cuda's signature that shards the
    window batch over `devices` (default: every visible GPU). The batch is
    padded to a multiple of the device count by repeating its last window;
    the padding's rows are dropped. Under --ed_thr the per-window monomer
    tensors (rank 3) are padded and split with the windows; a rank-2
    monomer tensor is copied once to each device. `inner_fn` is the
    per-shard program (default by the shard's device type: K1's wrapper on
    a GPU, the plain twin on the CPU)."""
    devs = _resolve(devices)
    n_dev = len(devs)
    replicas = _Replicas()

    def forward(windows, window_lens, mono, mono_lens, *, ins=-1, dele=-1, mismatch=-1,
                match=1, max_blocks=0):
        B, W = windows.shape
        dev = windows.device
        S = -(-B // n_dev)
        pad = S * n_dev - B if B else 0
        per_window = mono.dim() == 3
        windows, window_lens = _pad_rows(windows, pad), _pad_rows(window_lens, pad)
        if per_window:
            mono, mono_lens = _pad_rows(mono, pad), _pad_rows(mono_lens, pad)
        kw = dict(ins=ins, dele=dele, mismatch=mismatch, match=match,
                  max_blocks=max_blocks or W)
        outs = []
        for i, d in enumerate(devs):
            rows = slice(i * S, (i + 1) * S)
            if per_window:
                m, ml = (x[rows].to(d, non_blocking=True) for x in (mono, mono_lens))
            else:
                m, ml = replicas.on("mono", mono, d), replicas.on("mono_lens", mono_lens, d)
            inner = inner_fn or (chain_dp_forward_cuda if d.type == "cuda"
                                 else k1_plain.chain_dp_forward)
            with device_guard(d):
                outs.append(inner(windows[rows].to(d, non_blocking=True),
                                  window_lens[rows].to(d, non_blocking=True), m, ml, **kw))
        blocks = torch.cat([o[0].to(dev, non_blocking=True) for o in outs])
        counts = torch.cat([o[1].to(dev, non_blocking=True) for o in outs])
        return blocks[:B], counts[:B]

    return forward


def make_sharded_identity(devices=None):
    """K2's pairwise entry (light mode's identity_fn) with the pair axis
    sharded over `devices`: (dist, matches, columns) per pair, as
    ops/identity_cuda.nw_identity_batch_cuda. Pairs are padded to a
    multiple of the device count by repeating the last pair, and the
    padding's results are dropped; every pair's result is exact at any
    padded width, so the bytes do not depend on the shard count."""
    devs = _resolve(devices)
    n_dev = len(devs)

    def kernel(q, q_lens, t, t_lens):
        P = q.shape[0]
        dev = q.device
        if P == 0:
            return nw_identity_batch_cuda(q, q_lens, t, t_lens)
        S = -(-P // n_dev)
        pad = S * n_dev - P
        q, q_lens, t, t_lens = (_pad_rows(x, pad) for x in (q, q_lens, t, t_lens))
        outs = []
        for i, d in enumerate(devs):
            rows = slice(i * S, (i + 1) * S)
            inner = nw_identity_batch_cuda if d.type == "cuda" else k2_plain.nw_identity_batch
            with device_guard(d):
                outs.append(inner(*(x[rows].to(d, non_blocking=True)
                                    for x in (q, q_lens, t, t_lens))))
        return tuple(torch.cat([o[k].to(dev, non_blocking=True) for o in outs])[:P]
                     for k in range(3))

    return kernel


def make_sharded_packed(devices=None):
    """The --second-best finishing call (packed_fn, the contract of
    ops/identity_cuda.nw_identity_packed_both) with the block axis sharded
    over `devices`: each device takes a contiguous run of the blocks, with
    its own copy of the read and of the monomer tensors, and the last one
    also the call's padding blocks past len(starts). The pieces of the
    [2, n_pad * M, 2] result are concatenated in order: the bytes of the
    single call, which the JAX package's sharded identity kernel computes
    for the same pairs."""
    devs = _resolve(devices)
    replicas = _Replicas()

    def packed(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo, n_pad, Lq):
        n = len(starts)
        dev = read.device
        n_dev = min(len(devs), n)
        if n_dev == 0:
            return nw_identity_packed_both(read, starts, lens, t_raw, tl_raw, t_homo, tl_homo,
                                           n_pad, Lq)
        S = -(-n // n_dev)
        cuts = [min(i * S, n) for i in range(n_dev)] + [n]
        starts, lens = np.asarray(starts), np.asarray(lens)
        outs = []
        for i, d in enumerate(devs[:n_dev]):
            a, b = cuts[i], cuts[i + 1]
            if a == b:
                continue
            inner = (nw_identity_packed_both if d.type == "cuda"
                     else k2_plain.nw_identity_packed_both_plain)
            on = [replicas.on(name, x, d) for name, x in (
                ("read", read), ("t_raw", t_raw), ("tl_raw", tl_raw), ("t_homo", t_homo),
                ("tl_homo", tl_homo))]
            with device_guard(d):
                outs.append(inner(on[0], starts[a:b], lens[a:b], *on[1:],
                                  n_pad=(b - a) if b < n else n_pad - a, Lq=Lq))
        return torch.cat([o.to(dev, non_blocking=True) for o in outs], dim=1)

    return packed
