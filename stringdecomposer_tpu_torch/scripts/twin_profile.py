#!/usr/bin/env python3
"""Where chip_smoke.py's time goes to the plain twins, by phase.

Runs chip_smoke.main (all phases, or the named ones after setup) with the
plain PyTorch twins it calls wrapped: K1's (ops/chain_dp), K2's
(ops/identity), K3's and its mirror (ops/hw_filter), K4-K6's
(ops/banded) and the alignment API's scans (ops/align). Each outermost
call is timed on the host clock between two synchronizes and its inputs
hashed (the function, the tensors' bytes, the keywords). At the end it
prints, per phase and twin, the calls, their seconds, and the calls (and
seconds) whose inputs an earlier call already had, largest first, and the
inputs that more than one phase ran. chip_smoke's checks, output and exit
code are unchanged; the syncs and hashes add to its time.

Usage (on the card): from the root of the checkout to profile, which
need not hold this file (a parent commit unpacked under build/, say),
    python PATH/TO/twin_profile.py [PHASE ...]
It imports that checkout's chip_smoke.py and stringdecomposer_tpu_torch.
"""

from __future__ import annotations

import collections
import hashlib
import os
import sys
import time

import torch

# (module of stringdecomposer_tpu_torch.ops, its twins)
TWINS = (("chain_dp", ("chain_dp_forward", "chain_dp_ablate", "block_walk")),
         ("hw_filter", ("hw_distance_batch", "hw_distance_myers")),
         ("identity", ("nw_identity_batch", "nw_identity_cross", "nw_identity_packed_both_plain",
                       "nw_path_spec")),
         ("banded", ("banded_final_column", "banded_final_column_myers", "semi_ends_myers")),
         ("align", ("dp_lastrow_batch", "dp_moves_batch")))


def _digest(x, h) -> None:
    if isinstance(x, torch.Tensor):
        h.update(repr((tuple(x.shape), x.dtype)).encode())
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    elif isinstance(x, (list, tuple)):
        for y in x:
            _digest(y, h)
    else:
        h.update(repr(x).encode())


def main(argv: list[str]) -> int:
    import importlib

    sys.path.insert(0, os.getcwd())
    import chip_smoke

    phase = [""]
    stats = collections.defaultdict(lambda: [0, 0.0, 0, 0.0])  # calls, s, repeated, s
    seen: dict[str, list[str]] = {}
    depth = [0]

    def wrap(mod, name):
        fn = getattr(mod, name)

        def timed_twin(*a, **k):
            if depth[0]:  # a twin's own calls of another
                return fn(*a, **k)
            h = hashlib.sha256(name.encode())
            _digest(a, h)
            _digest([(kk, v) for kk, v in sorted(k.items()) if not callable(v)], h)
            key = h.hexdigest()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                s = stats[(phase[0], name)]
                s[0] += 1
                s[1] += dt
                if key in seen:
                    s[2] += 1
                    s[3] += dt
                seen.setdefault(key, []).append(phase[0])

        setattr(mod, name, timed_twin)

    for mod, names in TWINS:
        for name in names:
            wrap(importlib.import_module(f"stringdecomposer_tpu_torch.ops.{mod}"), name)
    run_phase = chip_smoke.Smoke.phase

    def named_phase(self, name, fn):
        phase[0] = name
        return run_phase(self, name, fn)

    chip_smoke.Smoke.phase = named_phase
    rc = chip_smoke.main(argv)
    print("TWIN PROFILE (phase, twin: calls, s, calls on inputs already run, their s)")
    for (ph, name), (c, s, dc, ds) in sorted(stats.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ph:12s} {name:32s} {c:5d} {s:9.2f} s  repeated {dc:4d} {ds:8.2f} s")
    cross = collections.Counter(tuple(p) for p in seen.values() if len(set(p)) > 1)
    print("inputs run in more than one phase:", dict(cross))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
