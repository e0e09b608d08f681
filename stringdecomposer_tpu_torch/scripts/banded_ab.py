#!/usr/bin/env python3
"""K4, K5 and K6, the banded kernels of the alignment API, of one checkout
of this repo, timed on the card, for an A/B of two commits on one card.

Unpack the other commit's port into a directory that .gitignore lists
(`mkdir -p build/parent && git archive <commit> stringdecomposer_tpu_torch |
tar -x -C build/parent`), then, in one chip call, run this script once per
turn, parent, change, change, parent, each in a fresh process:

    python3 stringdecomposer_tpu_torch/scripts/banded_ab.py build/parent
    python3 stringdecomposer_tpu_torch/scripts/banded_ab.py .

ROOT is the directory that holds the checkout's `stringdecomposer_tpu_torch`;
that package, with the kernels its own runtime/build.py builds, is what
runs. The workloads come from `workloads.align_pairs` beside this script
(numpy.random.default_rng(0)), whatever the checkout, as does the
scaffolding shared with k1_ab.py and k2_ab.py (`ab_common.py`):
  - kernels alone, through the checkout's wrappers on the card: K5 at
    k = 4,096 on q 5,121 bp x t 1,024 bp (chip_smoke's shape, the 262,144
    bp path's top-level band cut) and on the whole 262,144 bp pair; K6
    under HW and SHW on the 4,096 bp query x the first 2,048 bp of its
    1,048,576 bp target (chip_smoke's shape) and x the whole target; K6's
    wide route under HW on a 17,000 bp query (seed 3) x 2,048 bp and x
    1,048,576 bp (seed 4; in the checkout's plan and, where the checkout
    takes seg_cols there, one block a pair); K4 on each route the checkout
    has (a checkout without K4's `route=` runs its one kernel as "wide")
    and K5 at k = 8, 16, 32, 64, 128 and 256 on the 262,144 bp pair (the
    k-doubling's bands), on the transposed SHW sweep of the 4 kbp query
    (q 4,096 + k + 1 bp of the target x t 4,096 bp) and on 64 pairs of
    2,048 bp (numpy seed 1, 1 % divergence: a Hirschberg level's batch),
    to say where MYERS_MIN_K belongs; K4's and K5's wide routes at the
    40 kbp NW distance's bands (`workloads.wide_pairs`, numpy seed 3): K4
    in mask mode (the query as align's equality bitmasks under ("N", "A"),
    which changes no match) at k = 256 .. 8,192 on the cut shape q k +
    1,025 bp x t 1,024 bp and on the whole pair, K5 at k = 8,192 on q
    9,217 bp x t 1,024 bp and on the whole pair, and K5's wide route forced
    at k = 4,096 on q 5,121 bp x t 1,024 bp and on the 262,144 bp pair,
    against its warp route there; K4's wide route on tall pairs with a
    narrow band, the 262,144 bp pair at k = 512 and 1,024 and 64 windows of
    32,768 bp of it (3,584 bp apart) at k = 256. One warm-up call, then REPS (whole
    sizes: FULL_REPS) calls timed with CUDA events (ms), and a digest of
    the output, so that the turns can be held equal;
  - end to end (`ops/align.align` on the card): the NW path and the NW
    distance (k = -1) of the 262,144 bp pair, the NW distance of the 40 kbp
    pair in plain and in mask mode, and SHW and HW distance and locations
    of the 4 kbp query in the 1 Mbp target at k = 64, 256 and -1. One
    warm-up run, then E2E_REPS runs (the path: PATH_REPS) on the host clock
    up to a synchronize, and a digest of each result.
With `--sweep` (a checkout with K6's segments), K6 under HW on the whole 1
Mbp target at forced segment sizes S (nseg = 132 x m warps for m = 1 .. 32,
and S = 256 .. 16,384), beside the plan's, each with its digest and the
card's resident warps an SM: the data behind SEG_WARPS_PER_SM; and, where
the checkout has `wide_segment_plan`, K6's wide route on the 17,000 bp
query x 1,048,576 bp at nseg = SMs x m blocks (m = 1 .. the card's
resident blocks an SM, and 8) and S = 1,024 .. 65,536, beside its plan's.
With `--crossover` (no parent), the NW path of the 262,144 bp pair with
`MYERS_MIN_K` at 64 and at 128 in turn (64, 128, 128, 64, twice): each
run's wall time and digest, and every banded sweep the path makes, timed
on the host clock by its k (K4 below MYERS_MIN_K, K5 from it); then the
sweeps of one run at k = 32, 64 and 128 replayed on each kernel alone
(K4's warp route on the codes, K5 on the compact alphabet, CUDA events):
the path's own batches, to say where MYERS_MIN_K belongs.
With `--k4-stages` (this checkout), K4's wide route at forced stages a
band (32 .. 512) beside its own shape's, on the 262,144 bp pair at k = 256
and 1,024, the 64 tall pairs at k = 256 and the 40 kbp pair in mask mode
at k = 8,192, whole and cut: the data behind banded_wide_shape's stages.
With `--profile`, one HW locations run at k = 64 under torch.profiler: the
device time by kernel, largest first, and the device's busy total (the
kernels' self time); and K6 alone on the same pair with CUDA events.
Prints one JSON line: the checkout, the card's name and power limit, the
ptxas register and spill lines of its banded and Myers entries (from its
build.log) and the times.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import sys
import time

import numpy as np
from ab_common import checkout, ms

REPS = 5
FULL_REPS = 3
WIDE_KS = (256, 512, 1024, 2048, 4096, 8192)  # the 40 kbp NW distance's wide bands
E2E_REPS = 3
PATH_REPS = 2


def digest(x) -> str:
    import torch

    if isinstance(x, torch.Tensor):
        return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()[:16]
    return hashlib.sha256(json.dumps(x, sort_keys=True).encode()).hexdigest()[:16]


def timed(torch, fn, reps) -> dict:
    out = fn()
    t = ms(torch, fn, reps)
    return {"ms": t, "median_ms": sorted(t)[len(t) // 2], "digest": digest(out)}


def inputs(torch, dev, np, encode, al, s):
    """{name: [q, q_lens, t, t_lens]} on the card: the kernels' shapes."""
    def pair(qs, ts):
        codes = [torch.from_numpy(encode(x).astype(np.int32)[None, :]).to(dev) for x in (qs, ts)]
        return [codes[0], torch.tensor([len(qs)], dtype=torch.int32, device=dev),
                codes[1], torch.tensor([len(ts)], dtype=torch.int32, device=dev)]

    import workloads

    # the 40 kbp pair, and its query as align's equality bitmasks (mask mode)
    q40, t40, _, _ = workloads.wide_pairs(np.random.default_rng(3))
    raw = [al._encode_any(x) for x in (q40, t40)]
    enc = al._equality_encoding(raw, [("N", "A")])

    def mask_pair(nq, nt):
        mq, mt = enc.q_lut[raw[0][:nq]], enc.t_lut[raw[1][:nt]].astype(np.int32)
        return [torch.from_numpy(np.ascontiguousarray(mq[None, :])).to(dev),
                torch.tensor([len(mq)], dtype=torch.int32, device=dev),
                torch.from_numpy(np.ascontiguousarray(mt[None, :])).to(dev),
                torch.tensor([len(mt)], dtype=torch.int32, device=dev)]

    wide = {f"k4m {k} cut": mask_pair(k + 1025, 1024) for k in WIDE_KS}
    wide.update({"k4m whole": mask_pair(len(q40), len(t40)),
                 "k5 9217x1024": pair(q40[:9217], t40[:1024]), "nw 40000": pair(q40, t40)})

    rng = np.random.default_rng(1)
    pairs = [workloads.synth_pair(2048, 0.01, rng) for _ in range(64)]
    batch = []
    for side in (0, 1):
        seqs = [encode(p[side]).astype(np.int32) for p in pairs]
        arr = np.zeros((64, max(len(x) for x in seqs)), dtype=np.int32)
        for i, x in enumerate(seqs):
            arr[i, : len(x)] = x
        batch += [torch.from_numpy(arr).to(dev),
                  torch.tensor([len(x) for x in seqs], dtype=torch.int32, device=dev)]
    r = np.random.default_rng(3)
    q17 = "".join(np.array(list("ACGT"))[r.integers(0, 4, 17_000)])
    r = np.random.default_rng(4)
    t1m = "".join(np.array(list("ACGT"))[r.integers(0, 4, 1 << 20)])
    # a batch of tall pairs: 64 windows of 32,768 bp of the 262,144 bp pair,
    # 3,584 bp apart
    tall = [pair(s["q"][o : o + 32768], s["t"][o : o + 32768]) for o in range(0, 64 * 3584, 3584)]
    tall = [torch.cat([x[i] for x in tall]) for i in range(4)]
    return {"k5 5121x1024": pair(s["q"][:5121], s["t"][:1024]),
            "nw 262144": pair(s["q"], s["t"]), "tall 64x32768": tall,
            "k6 4096x2048": pair(s["tq"], s["big_t"][:2048]),
            "k6 4096x1M": pair(s["tq"], s["big_t"]),
            "k6 17000x2048": pair(q17, t1m[:2048]),
            "k6 17000x1M": pair(q17, t1m),
            "batch 64x2048": batch, **wide}


def kernels(torch, bc, x) -> dict:
    out = {}
    out["K5 k=4096 q 5121 x t 1024"] = timed(
        torch, lambda: bc.banded_myers_cuda(*x["k5 5121x1024"], k=4096), REPS)
    out["K5 k=4096 q 262144 x t 262144"] = timed(
        torch, lambda: bc.banded_myers_cuda(*x["nw 262144"], k=4096), FULL_REPS)
    for hw in (True, False):
        mode = "HW" if hw else "SHW"
        out[f"K6 {mode} q 4096 x t 2048"] = timed(
            torch, lambda: bc.semi_ends_cuda(*x["k6 4096x2048"], free_target_prefix=hw), REPS)
        out[f"K6 {mode} q 4096 x t 1048576"] = timed(
            torch, lambda: bc.semi_ends_cuda(*x["k6 4096x1M"], free_target_prefix=hw), FULL_REPS)
    # K6's wide route (17,000 rows: 532 words)
    out["K6 wide HW q 17000 x t 2048"] = timed(
        torch, lambda: bc.semi_ends_cuda(*x["k6 17000x2048"]), REPS)
    out["K6 wide HW q 17000 x t 1048576, plan"] = timed(
        torch, lambda: bc.semi_ends_cuda(*x["k6 17000x1M"]), FULL_REPS)
    try:
        out["K6 wide HW q 17000 x t 1048576, one block"] = timed(
            torch, lambda: bc.semi_ends_cuda(*x["k6 17000x1M"], seg_cols=0), FULL_REPS)
    except ValueError as e:  # a checkout whose wide route takes no segments
        out["K6 wide HW q 17000 x t 1048576, one block"] = {"skipped": str(e)}
    k4 = bc.banded_final_column_cuda
    k4_routes = "route" in inspect.signature(k4).parameters
    # K4's wide route in mask mode and K5's at the 40 kbp NW distance's bands
    wide4 = dict(route="wide") if k4_routes else {}
    for k in WIDE_KS:
        out[f"K4 wide mask k={k} q {k + 1025} x t 1024"] = timed(
            torch, lambda: k4(*x[f"k4m {k} cut"], k=k, use_mask=True, **wide4), REPS)
        out[f"K4 wide mask k={k} q 40000 x t 40000"] = timed(
            torch, lambda: k4(*x["k4m whole"], k=k, use_mask=True, **wide4), FULL_REPS)
    # K4's wide route on tall pairs whose band is narrow against their rows:
    # the 262,144 bp pair at k = 512 and 1,024 (k <= 256 below), and a batch
    # of 64 pairs of 32,768 bp at k = 256
    for k in (512, 1024):
        out[f"K4 wide k={k} q 262144 x t 262144"] = timed(
            torch, lambda: k4(*x["nw 262144"], k=k, **wide4), FULL_REPS)
    out["K4 wide k=256 64 pairs x 32768"] = timed(
        torch, lambda: k4(*x["tall 64x32768"], k=256, **wide4), FULL_REPS)
    out["K5 wide k=8192 q 9217 x t 1024"] = timed(
        torch, lambda: bc.banded_myers_cuda(*x["k5 9217x1024"], k=8192), REPS)
    out["K5 wide k=8192 q 40000 x t 40000"] = timed(
        torch, lambda: bc.banded_myers_cuda(*x["nw 40000"], k=8192), FULL_REPS)
    out["K5 wide k=4096 q 5121 x t 1024"] = timed(
        torch, lambda: bc.banded_myers_cuda(*x["k5 5121x1024"], k=4096, route="wide"), REPS)
    out["K5 wide k=4096 q 262144 x t 262144"] = timed(
        torch, lambda: bc.banded_myers_cuda(*x["nw 262144"], k=4096, route="wide"), FULL_REPS)
    q, ql, t, tl = x["k6 4096x1M"]
    for k in (8, 16, 32, 64, 128, 256):
        shw = [t[:, : 4096 + k + 1].contiguous(), torch.tensor([4096 + k + 1], dtype=torch.int32,
                                                               device=t.device), q, ql]
        for name, args, reps in (("q 262144 x t 262144", x["nw 262144"], FULL_REPS),
                                 (f"SHW transposed q {4096 + k + 1} x t 4096", shw, REPS),
                                 ("64 pairs x 2048", x["batch 64x2048"], REPS)):
            for route in ("warp", "wide"):
                if k4_routes and (route == "wide" or 2 * k + 1 <= bc.WARP_MAX_WORDS):
                    out[f"K4 {route} k={k} {name}"] = timed(
                        torch, lambda: k4(*args, k=k, route=route), reps)
                elif not k4_routes and route == "wide":
                    out[f"K4 {route} k={k} {name}"] = timed(torch, lambda: k4(*args, k=k), reps)
            out[f"K5 k={k} {name}"] = timed(
                torch, lambda: bc.banded_myers_cuda(*args, k=k), reps)
    return out


def e2e(torch, al, s, w) -> dict:
    def walls(fn, reps):
        res = fn()
        torch.cuda.synchronize()
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return {"s": secs, "digest": digest(res)}

    out = {"NW path 262144": walls(lambda: al.align(s["q"], s["t"], mode="NW", task="path",
                                                     device="cuda"), PATH_REPS),
           "NW distance 262144 k=-1": walls(lambda: al.align(s["q"], s["t"], mode="NW",
                                                             device="cuda"), E2E_REPS),
           "NW distance 40000 k=-1": walls(lambda: al.align(w[0], w[1], mode="NW",
                                                            device="cuda"), E2E_REPS),
           "NW distance 40000 k=-1 mask mode": walls(
               lambda: al.align(w[0], w[1], mode="NW", additionalEqualities=[("N", "A")],
                                device="cuda"), E2E_REPS)}
    for mode in ("SHW", "HW"):
        for task in ("distance", "locations"):
            for k in (64, 256, -1):
                out[f"{mode} {task} 4096 x 1M k={k}"] = walls(
                    lambda: al.align_batch([s["tq"]], [s["big_t"]], mode=mode, task=task, k=k,
                                           device="cuda")[0], E2E_REPS)
    return out


def sweep(torch, bc, x) -> dict:
    q, ql, t, tl = x["k6 4096x1M"]
    Lt = t.shape[1]
    W = -(-q.shape[1] // 32)
    sms, resident = bc._card_warps(q.device.index, W)
    sizes = {-(-Lt // (32 * sms * m)) * 32 for m in (1, 2, 4, 8, 16, 32)}
    sizes |= {256 << i for i in range(7)}
    out = {"sms": sms, "resident_warps_per_sm": resident,
           "plan": list(bc.segment_plan(1, q.shape[1], Lt, sms, resident)),
           "plan_ms": timed(torch, lambda: bc.semi_ends_cuda(q, ql, t, tl), REPS)}
    for S in sorted(sizes):
        row = timed(torch, lambda: bc.semi_ends_cuda(q, ql, t, tl, seg_cols=S), REPS)
        row["nseg"] = -(-Lt // S)
        out[f"S={S}"] = row
    return out


def wide_sweep(torch, bc, x) -> dict:
    q, ql, t, tl = x["k6 17000x1M"]
    Lq, Lt = q.shape[1], t.shape[1]
    stages = bc.wide_shape(Lq)[0]
    sms, resident = bc._card_blocks(q.device.index, stages)
    nsegs = {sms * m for m in range(1, resident + 1)} | {sms * 8}
    sizes = {-(-Lt // (32 * n)) * 32 for n in nsegs} | {1024 << i for i in range(7)}
    out = {"sms": sms, "stages": stages, "resident_blocks_per_sm": resident,
           "plan": list(bc.wide_segment_plan(1, Lq, Lt, sms, resident)),
           "plan_ms": timed(torch, lambda: bc.semi_ends_cuda(q, ql, t, tl), REPS)}
    for S in sorted(sizes):
        row = timed(torch, lambda: bc.semi_ends_cuda(q, ql, t, tl, seg_cols=S), REPS)
        row["nseg"] = -(-Lt // S)
        out[f"S={S}"] = row
    return out


def k4_stages(torch, banded, bc, x) -> dict:
    """K4's wide route at forced stages a band (banded_wide_shape's
    `stages`), beside the shape's own: the 262,144 bp pair at k = 256 and
    1,024, the batch of 64 tall pairs at k = 256, and the 40 kbp pair in
    mask mode at k = 8,192, whole and cut to q 9,217 x t 1,024."""
    keep = banded.banded_wide_shape
    out = {}
    for what, args, k, mask in (("q 262144 x t 262144", x["nw 262144"], 256, False),
                                ("q 262144 x t 262144", x["nw 262144"], 1024, False),
                                ("64 pairs x 32768", x["tall 64x32768"], 256, False),
                                ("q 40000 x t 40000 mask", x["k4m whole"], 8192, True),
                                ("q 9217 x t 1024 mask", x["k4m 8192 cut"], 8192, True)):
        Lq, Lt = args[0].shape[1], args[2].shape[1]
        for st in (None, 32, 64, 128, 256, 320, 512):
            banded.banded_wide_shape = (keep if st is None else
                                        lambda a, b, c, st=st: keep(a, b, c, stages=st))
            try:
                row = timed(torch, lambda: bc.banded_final_column_cuda(
                    *args, k=k, use_mask=mask, route="wide"), FULL_REPS)
            finally:
                banded.banded_wide_shape = keep
            row["shape"] = list(keep(Lq, Lt, k, stages=st))
            out[f"K4 wide k={k} {what} stages={st or 'own'}"] = row
    return out


def crossover(torch, al, banded, bc, s) -> dict:
    """The NW path at MYERS_MIN_K = 64 and 128 in turn, its banded sweeps
    timed by k; then one run's sweeps at k = 32, 64, 128 on each kernel."""
    orig, calls = al._banded_final_column, []

    def traced(q, ql, t, tl, k, use_mask=False, eq_flat=None, *, device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(q, ql, t, tl, k, use_mask=use_mask, eq_flat=eq_flat, device=device)
        calls.append((int(k), time.perf_counter() - t0, (q, ql, t, tl)))
        return out  # a NumPy array: the call has synchronized

    keep = banded.MYERS_MIN_K
    out, batches = {"runs": []}, {}
    al._banded_final_column = traced
    try:
        for i, min_k in enumerate((64, 128, 128, 64, 64, 128, 128, 64)):
            banded.MYERS_MIN_K = min_k
            if i < 2:  # a warm-up run at each setting
                al.align(s["q"], s["t"], mode="NW", task="path", device="cuda")
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = al.align(s["q"], s["t"], mode="NW", task="path", device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            by_k = {}
            for k, sec, args in calls:
                n, tot = by_k.get(k, (0, 0.0))
                by_k[k] = (n + 1, tot + sec)
                if i == 0 and k in (32, 64, 128):
                    batches.setdefault(k, []).append(args)
            out["runs"].append({"MYERS_MIN_K": min_k, "s": wall, "digest": digest(res),
                                "sweeps_by_k": {k: [n, tot] for k, (n, tot) in sorted(by_k.items())}})
    finally:
        al._banded_final_column = orig
        banded.MYERS_MIN_K = keep
    dev = torch.device("cuda")
    for k, group in sorted(batches.items()):
        k4 = k5 = 0.0
        shapes = []
        for q, ql, t, tl in group:
            args = [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)
                    for a in (q, ql, t, tl)]
            remap = al._myers_compact_alphabet(q, ql, t, tl)
            margs = [torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)
                     for a in (remap[0], ql, remap[1], tl)]
            k4 += sum(ms(torch, lambda: bc.banded_final_column_cuda(*args, k=k), REPS)) / REPS
            k5 += sum(ms(torch, lambda: bc.banded_myers_cuda(*margs, k=k), REPS)) / REPS
            shapes.append([q.shape[0], q.shape[1], t.shape[1]])
        out[f"k={k} kernels alone"] = {"sweeps": len(group), "K4_ms": k4, "K5_ms": k5,
                                       "shapes [P, Lq, Lt]": shapes}
    return out


def profile(torch, al, bc, x, s) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    def run():
        return al.align_batch([s["tq"]], [s["big_t"]], mode="HW", task="locations", k=64,
                              device="cuda")[0]

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves, not the operators that launched them
    rows = sorted((e for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA), key=dev_us, reverse=True)
    return {"wall_s": wall, "busy_ms": sum(dev_us(e) for e in rows) / 1e3,
            "device_by_kernel": [[e.key[:60], e.count, dev_us(e) / 1e3] for e in rows[:15]],
            "k6_alone": timed(torch, lambda: bc.semi_ends_cuda(*x["k6 4096x1M"]), REPS)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", help="directory holding the checkout's stringdecomposer_tpu_torch")
    ap.add_argument("--sweep", action="store_true", help="K6's segment sizes instead")
    ap.add_argument("--profile", action="store_true", help="profile HW locations instead")
    ap.add_argument("--crossover", action="store_true",
                    help="the NW path at MYERS_MIN_K = 64 and 128 instead")
    ap.add_argument("--k4-stages", action="store_true",
                    help="K4's wide route at forced stages a band instead")
    args = ap.parse_args()
    torch, res = checkout(args.root, ("myers", "semi", "peq", "banded_kernel", "banded_warp",
                                      "banded_wide"), "banded_ab")
    import numpy as np
    import workloads
    from stringdecomposer_tpu_torch.io.fasta import encode
    from stringdecomposer_tpu_torch.ops import align as al
    from stringdecomposer_tpu_torch.ops import banded_cuda as bc

    dev = torch.device("cuda")
    s = workloads.align_pairs(np.random.default_rng(0))
    x = inputs(torch, dev, np, encode, al, s)
    if args.sweep:
        res["sweep"] = sweep(torch, bc, x)
        if hasattr(bc, "wide_segment_plan"):
            res["wide_sweep"] = wide_sweep(torch, bc, x)
    elif args.crossover:
        from stringdecomposer_tpu_torch.ops import banded

        res["crossover"] = crossover(torch, al, banded, bc, s)
    elif args.k4_stages:
        from stringdecomposer_tpu_torch.ops import banded

        res["k4_stages"] = k4_stages(torch, banded, bc, x)
    elif args.profile:
        res["profile"] = profile(torch, al, bc, x, s)
    else:
        res["kernels"] = kernels(torch, bc, x)
        res["e2e"] = e2e(torch, al, s, workloads.wide_pairs(np.random.default_rng(3)))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
