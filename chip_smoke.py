#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (stringdecomposer_tpu_torch) on one GPU.

Builds the hand-written kernels from csrc/, checks each against its plain
PyTorch twin on the card (bit-equal: all outputs are integers) and against
the reference fixtures, drives the golden CLI run through the kernels and
a 1.6 Mbp synthetic assembly through both routes, drives the --ed_thr
pre-filter (K3: its thread route on the DXZ1 monomers and the library, its
warp route past 512 bp on the DXZ1 trimers, its wide route past 16,384 bp
on a ~17 kbp unit of 100 DXZ1 monomers, each against the plain twin and the
mirror `hw_distance_myers`) and a HOR-scale monomer library (`hor_library`, 264
monomers with RC, which takes K1's large route unfiltered, on its cluster
body), drives the golden read against DXZ1 dimers (`workloads.joined_set`,
L = 360: K1's lanes body at C = 12) and against 150 dimer variants
(`workloads.joined_variants`, too large for the shared route: the cluster
body at L = 360), and against DXZ1 trimers and 150 trimer variants (L =
528, past the lanes and cluster bodies' 512: K1's tiled body on the shared
route and its tiled cluster body on the large route) and against the DXZ1
HOR unit (`workloads.hor_unit`, L = 2,056: the tiled body, a row over two
warps), drives a ~17 kbp unit through decompose_reads unfiltered (the tiled
cluster body, a row a block), holds K1's chunked body to its plain twin at
the shapes it keeps (phase `chunked`), drives the
general alignment API through K4, K5 and K6 (the reference edlib fixtures,
a 262,144 bp NW path and a 4 kbp query against a 1 Mbp target, and both at
cut sizes against the scan route; K4, K5 and K6 on their warp routes, K6's
HW in segments; their wide routes on a 40 kbp NW distance (K4's in mask
mode) and a 17 kbp HW query in 20 kbp and in 1 Mbp (K6's in segments),
each checked against the other route at its shapes), checks P (the int16 probe) and K1's
int16 state on both routes against the int16 twin and the int32 kernel and
drives that path, checks K1's ablation kernels (A) against their plain
versions and runs the ablation bench (at an eighth of its positions), then
times each kernel beside its plain version at the main path's shapes and
prints each one's bound. Phase `modes` drives the CLI's one-GPU run modes
on the golden read (--stream-reads, --resume, --serve with --precompile as
a subprocess, --profile-dir with the device's busy and idle share from its
trace). Phase `parallel` drives the scale-out modes on the one card: the
sharded functions of parallel/sharding.py at [cuda:0] x 2 and x 3 against
one call, the alignment API's row split against one device, the CLI with
--data-parallel (the golden read; 1.6 Mbp with its batches in flight), two
CLI processes as two hosts (--num-hosts 2) and as a torch.distributed
group (--coordinator) against one process, and the reliability trainer on
the card against the CPU. K2 runs through both of its entries: the cross
entry (`nw_identity_cross`, every block x every monomer) on the
--second-best path, the pairwise one (`nw_identity`) in light mode; its
times are of the launches alone, apart from the packed call.

Usage: python3 chip_smoke.py           (needs one CUDA device; exits non-zero
without one, and prints no result)
       python3 chip_smoke.py PHASE ...  (setup and the named phases only, in
the script's order, for a quicker check on the card; no result line)
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "stringdecomposer_tpu", "test_data")
FIXTURES = os.path.join(HERE, "tests", "fixtures")
VARIANTS = ("base", "nochain", "ladder4", "ladder2", "noemit", "noshift")  # ops/chain_dp.VARIANTS
ABLATE = tuple(f"ablate_{'large_' if large else ''}{v}" for large in (False, True) for v in VARIANTS)
KERNELS = ("chain_dp", "chain_dp_large", "block_walk", "nw_identity", "nw_identity_cross", "hw_filter",
           "hw_filter_warp", "hw_filter_wide", "banded_final_column", "banded_myers", "semi_ends",
           "banded_final_column_wide", "banded_myers_wide", "semi_ends_wide",
           "int16_probe", "chain_dp_int16",
           "chain_dp_large_int16", "chain_dp_lanes", "chain_dp_lanes_int16", "chain_dp_cluster",
           "chain_dp_cluster_int16", "chain_dp_lanes_long", "chain_dp_lanes_long_int16",
           "chain_dp_cluster_long", "chain_dp_cluster_long_int16", "chain_dp_tiled",
           "chain_dp_tiled_int16", "chain_dp_cluster_tiled",
           "chain_dp_cluster_tiled_int16") + ABLATE
# K1's kernel bodies (ops/chain_dp_cuda.body) -> chip_smoke kernel names
K1_NAMES = {"lanes": "chain_dp_lanes", "chunked": "chain_dp", "large": "chain_dp_large",
            "cluster": "chain_dp_cluster", "tiled": "chain_dp_tiled",
            "cluster_tiled": "chain_dp_cluster_tiled"}
# every K1 body's kernel names (and launch counters), int32 and int16
K1_BODY_NAMES = tuple(k for k in KERNELS if k.startswith("chain_dp"))
# The card's peak rates for the bounds (H100 SXM datasheet, 700 W): HBM at
# 3.35 TB/s; int32 at 64 INT32 lanes per SM per clock (half the 128 FP32
# lanes behind the datasheet's 67 TFLOP/s float32, which counts an FMA as 2)
# x 132 SMs x 1.98 GHz = 16.73 T int32 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations per DP cell (or per 32-row word of a bit-parallel
# column), counted from each recurrence itself, not from a kernel's own
# formulation of it (no fold offsets, nothing that depends only on k):
#   K1 and its ablations, 15: match test and select 2; the diag, ins, del
#     and enter adds 4; three maxima 3; the start pointer's three compares
#     and three selects 6;
#   K2, 11: match test 1, three candidates 3, two min 2, the column count's
#     preference 2 compares + 2 selects + 1 add (matches = columns - D is
#     one subtraction a pair, not a cell);
#   K4, 6: match test 1, three candidates 3, two min 2 (also K3's cell-DP
#     bound, printed beside its Myers bound); K4 and K5 count the band's
#     cells at each column j, rows max(0, j - k) .. min(q_len, j + k)
#     (band_rows; K5 in 32-row words, ceil(rows / 32) a column), not 2k + 1;
#   K5 and K6, 11 per word: K3's HW step below (10; K6 computes D(q_len,
#     j), K5 the band's column, each with the same column step, both
#     csrc/myers_wide.cuh's stage_column; K5's band masks are a stage's,
#     not a word's) and 1 to pick the Eq word by the target code (a select;
#     K3 loads it);
#   K3, 10 per word: the HW step as the H100 can issue it, one instruction
#     each for X = Eq | VN, T = X & VP, the add with carry (IADD3), D0 =
#     (sum ^ VP) | X and HP = VN | ~(D0 | VP) (LOP3), HN = D0 & VP, the two
#     up-shifts of HP and HN (SHF funnel shifts), VP' = HN' | ~(D0 | HP')
#     (LOP3) and VN' = D0 & HP'. K3 computes its function bit-parallel, so
#     its bound counts a word per 32 monomer rows a window column, the least
#     work known for it;
#   the walk and P, 2 per element: compare, select.
OPS_PER_CELL = {"k1": 15, "k2": 11, "hw": 6, "myers_word": 11, "k3_word": 10, "semi_word": 11,
                "scan": 2}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take for the work: the larger of the
    bytes over the memory rate and the int32 ops over the int32 rate, in
    ms, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def band_rows(q_len: int, t_len: int, k: int):
    """The rows of the banded NW DP at each target column j = 1 .. t_len,
    max(0, j - k) .. min(q_len, j + k): the cells K4 and K5 must step (the
    column j = 0 is the boundary), a numpy array by column."""
    import numpy as np

    j = np.arange(1, t_len + 1, dtype=np.int64)
    return np.clip(np.minimum(q_len, j + k) - np.maximum(0, j - k) + 1, 0, None)


def hw_brute(q: str, t: str) -> int:
    """Infix (HW) edit distance by the full DP, one row at a time in numpy."""
    import numpy as np

    qa = np.frombuffer(q.encode(), dtype=np.uint8)
    ta = np.frombuffer(t.encode(), dtype=np.uint8)
    j = np.arange(len(ta) + 1)
    row = np.zeros(len(ta) + 1, dtype=np.int64)  # D[0][j] = 0
    for i in range(1, len(qa) + 1):
        cand = np.empty_like(row)
        cand[0] = i
        cand[1:] = np.minimum(row[1:] + 1, row[:-1] + (ta != qa[i - 1]))
        row = np.minimum.accumulate(cand - j) + j  # the left chain
    return int(row.min())


def cigar_cost(cigar: str, q: str, t: str) -> int:
    """The cost of an extended CIGAR as an alignment of q to t; raises
    unless it consumes both exactly and every '=' / 'X' run agrees with the
    characters."""
    import numpy as np

    qa = np.frombuffer(q.encode(), dtype=np.uint8)
    ta = np.frombuffer(t.encode(), dtype=np.uint8)
    i = j = cost = 0
    for num, op in re.findall(r"(\d+)([=XID])", cigar):
        n = int(num)
        if op in "=X":
            same = qa[i : i + n] == ta[j : j + n]
            if len(same) != n or not (same.all() if op == "=" else not same.any()):
                raise AssertionError(f"CIGAR run {num}{op} at q {i}, t {j} disagrees")
            i, j, cost = i + n, j + n, cost + (n if op == "X" else 0)
        else:
            i, j, cost = (i + n, j, cost + n) if op == "I" else (i, j + n, cost + n)
    if (i, j) != (len(qa), len(ta)):
        raise AssertionError(f"CIGAR consumes ({i}, {j}) of ({len(qa)}, {len(ta)})")
    return cost


class Smoke:
    def __init__(self):
        self.failed: list[str] = []
        self.max_err: dict[str, int] = {k: 0 for k in KERNELS}

    def phase(self, name, fn):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
            print(f"== phase {name}: ok in {time.perf_counter() - t0:.2f} s", flush=True)
        except Exception:  # noqa: BLE001 - report every phase, fail at the end
            traceback.print_exc(file=sys.stdout)
            print(f"== phase {name}: FAILED", flush=True)
            self.failed.append(name)

    def same(self, kernel: str, what: str, got, want) -> None:
        """Bit-equality of integer tensors; records the max abs error."""
        import torch

        got = torch.as_tensor(got).cpu().to(torch.int64)
        want = torch.as_tensor(want).cpu().to(torch.int64)
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got - want).abs().max()) if got.numel() else 0
        self.max_err[kernel] = max(self.max_err[kernel], err)
        if err:
            raise AssertionError(f"{what}: max abs error {err} (tolerance 0)")


def timed(fn, reps: int) -> tuple[list[float], object]:
    """Milliseconds per call, from CUDA events around each call, and the
    result of the warm-up call; reps = 0 times the one call itself."""
    import torch

    if reps == 0:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        res = fn()
        b.record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b)], res
    res = fn()  # warm-up
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out, res


def spread(ms: list[float]) -> str:
    return f"min {min(ms):.3f} / median {statistics.median(ms):.3f} / max {max(ms):.3f} ms"


def main(only: list[str]) -> int:
    if not os.path.isdir(os.path.join(HERE, "stringdecomposer_tpu_torch")):
        print("chip_smoke: stringdecomposer_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2

    from stringdecomposer_tpu_torch import cli, pipeline
    from stringdecomposer_tpu_torch.finishing import homo_compress
    from stringdecomposer_tpu_torch.io.fasta import (
        Record, add_rc_interleaved, add_reverse_complement, encode, load_fasta, pad_monomers,
        write_fasta,
    )
    from stringdecomposer_tpu_torch.ops import chain_dp as k1_plain
    from stringdecomposer_tpu_torch.ops import hw_filter as k3_plain
    from stringdecomposer_tpu_torch.ops import align as al
    from stringdecomposer_tpu_torch.ops import banded, banded_cuda
    from stringdecomposer_tpu_torch.ops import identity as k2_plain
    from stringdecomposer_tpu_torch.ops.banded_cuda import (
        banded_final_column_cuda, banded_myers_cuda, segment_plan, semi_ends_cuda,
        wide_segment_plan,
    )
    from stringdecomposer_tpu_torch.ops import chain_dp_cuda as k1
    from stringdecomposer_tpu_torch.ops.chain_dp_cuda import (
        block_walk_cuda, chain_dp_ablate_cuda, chain_dp_forward_cuda, chain_dp_large_cuda,
        int16_probe_cuda, int16_probe_plain, int16_state_supported, route,
    )
    from stringdecomposer_tpu_torch.ops.chain_dp_cuda import body as k1_body
    from stringdecomposer_tpu_torch.ops import hw_filter_cuda as k3
    from stringdecomposer_tpu_torch.ops.hw_filter_cuda import hw_distance_batch_cuda
    from stringdecomposer_tpu_torch.ops.identity_cuda import (
        C_MAX, nw_identity_batch_cuda, nw_identity_cross_cuda, nw_identity_packed_both,
    )
    from stringdecomposer_tpu_torch.ops.oracle import Scoring, make_windows
    from stringdecomposer_tpu_torch.report import format_raw_rows
    from stringdecomposer_tpu_torch.runtime import build
    from stringdecomposer_tpu_torch.scripts.workloads import (
        align_pairs, hor_library, hor_unit, joined_set, joined_variants, synth_pair, synthesize,
        wide_pairs as workload_wide_pairs,
    )

    def k1_name(body: str, L: int, state_bytes: int) -> str:
        """The kernel name (and launch counter) of a K1 body at rows padded
        to L: the lanes and cluster bodies' rows past k1.LANES_LONG_L (C =
        9..16, two rows a warp in registers) apart, int16 state apart."""
        long = "_long" if body in ("lanes", "cluster") and L > k1.LANES_LONG_L else ""
        return K1_NAMES[body] + long + ("_int16" if state_bytes == 2 else "")

    dev = torch.device("cuda")
    smoke = Smoke()
    kind = torch.cuda.get_device_name(0)
    timing: dict[str, tuple[float, float]] = {}
    bounds: dict[str, tuple[float, str]] = {}
    launches: dict[str, int] = {}
    # kernel -> (wrapper, counter attribute)
    counters = {"chain_dp": (chain_dp_forward_cuda, "launches"),
                "chain_dp_large": (chain_dp_large_cuda, "launches"),
                "block_walk": (block_walk_cuda, "launches"),
                "nw_identity": (nw_identity_batch_cuda, "launches"),
                "nw_identity_cross": (nw_identity_cross_cuda, "launches"),
                "hw_filter": (hw_distance_batch_cuda, "launches"),
                "hw_filter_warp": (hw_distance_batch_cuda, "launches_warp"),
                "hw_filter_wide": (hw_distance_batch_cuda, "launches_wide"),
                "banded_final_column": (banded_final_column_cuda, "launches"),
                "banded_final_column_wide": (banded_final_column_cuda, "launches_wide"),
                "banded_myers": (banded_myers_cuda, "launches"),
                "semi_ends": (semi_ends_cuda, "launches"),
                "banded_myers_wide": (banded_myers_cuda, "launches_wide"),
                "semi_ends_wide": (semi_ends_cuda, "launches_wide"),
                "int16_probe": (int16_probe_cuda, "launches"),
                "chain_dp_int16": (chain_dp_forward_cuda, "launches_int16"),
                "chain_dp_large_int16": (chain_dp_large_cuda, "launches_int16"),
                "chain_dp_lanes": (chain_dp_forward_cuda, "launches_lanes"),
                "chain_dp_lanes_int16": (chain_dp_forward_cuda, "launches_lanes_int16"),
                "chain_dp_cluster": (chain_dp_large_cuda, "launches_cluster"),
                "chain_dp_cluster_int16": (chain_dp_large_cuda, "launches_cluster_int16"),
                "chain_dp_lanes_long": (chain_dp_forward_cuda, "launches_lanes_long"),
                "chain_dp_lanes_long_int16": (chain_dp_forward_cuda, "launches_lanes_long_int16"),
                "chain_dp_cluster_long": (chain_dp_large_cuda, "launches_cluster_long"),
                "chain_dp_cluster_long_int16": (chain_dp_large_cuda,
                                                "launches_cluster_long_int16"),
                "chain_dp_tiled": (chain_dp_forward_cuda, "launches_tiled"),
                "chain_dp_tiled_int16": (chain_dp_forward_cuda, "launches_tiled_int16"),
                "chain_dp_cluster_tiled": (chain_dp_large_cuda, "launches_cluster_tiled"),
                "chain_dp_cluster_tiled_int16": (chain_dp_large_cuda,
                                                 "launches_cluster_tiled_int16")}
    counters.update({f"ablate_{'large_' if large else ''}{v}":
                     (chain_dp_ablate_cuda, k1.ablate_counter(v, large))
                     for large in (False, True) for v in VARIANTS})
    dxz1 = os.path.join(DATA, "DXZ1_star_monomers.fa")
    read_fa = os.path.join(DATA, "read.fa")
    plain_route = dict(forward_fn=k1_plain.chain_dp_forward,
                       identity_fn=k2_plain.nw_identity_batch,
                       packed_fn=k2_plain.nw_identity_packed_both_plain,
                       hw_fn=k3_plain.hw_distance_batch)
    tsvs = ("final_decomposition_raw.tsv", "final_decomposition.tsv",
            "final_decomposition_alt.tsv")
    work = tempfile.TemporaryDirectory()
    library = hor_library(load_fasta(dxz1), np.random.default_rng(0))
    library_fa = os.path.join(work.name, "hor_library.fa")
    write_fasta(library_fa, library)
    # K1's long rows: the DXZ1 dimers (M = 24, L = 360: the lanes body) and
    # 150 variants of them (the cluster body); the trimers (L = 528, past
    # 512: the tiled body) and 150 variants of them (the tiled cluster body);
    # the HOR unit (M = 2, L = 2,056: the tiled body, a row over two warps)
    joined = {}
    for k, what in ((2, "dimers"), (3, "trimers")):
        units = joined_set(load_fasta(dxz1), k)
        units_v = joined_variants(load_fasta(dxz1), k, 150, np.random.default_rng(0))
        joined[what] = (units, os.path.join(work.name, f"dxz1_{what}.fa"))
        joined[what + " variants"] = (units_v, os.path.join(work.name, f"dxz1_{what}_variants.fa"))
    joined["hor unit"] = (hor_unit(load_fasta(dxz1)), os.path.join(work.name, "dxz1_hor_unit.fa"))
    for records, path in joined.values():
        write_fasta(path, records)
    dimers, trimers, hor = joined["dimers"][0], joined["trimers"][0], joined["hor unit"][0]
    variants, trimer_variants = joined["dimers variants"][0], joined["trimers variants"][0]
    cache: dict[str, object] = {}

    class StreamLog(logging.Handler):
        """Keeps the DP stream's closing line of each run ("DP stream: N
        batches, at most D in flight")."""

        def __init__(self):
            super().__init__(logging.INFO)
            self.lines: list[str] = []

        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("DP stream: "):
                self.lines.append(msg)

    stream_log = StreamLog()
    sd_logger = logging.getLogger("SD-TPU")
    sd_logger.addHandler(stream_log)
    if sd_logger.level == logging.NOTSET or sd_logger.level > logging.INFO:
        sd_logger.setLevel(logging.INFO)

    def inflight_depth() -> str:
        """The DP stream line of the last run, then forgets the lines."""
        line = stream_log.lines[-1] if stream_log.lines else "no DP stream line"
        stream_log.lines.clear()
        return line

    def assembly_fa() -> str:
        """The 1.6 Mbp synthetic DXZ1 assembly (seed 0), written once."""
        if "asm" not in cache:
            asm = synthesize(1_600_000, load_fasta(dxz1), np.random.default_rng(0))
            cache["asm"] = os.path.join(work.name, "asm.fa")
            with open(cache["asm"], "w") as f:
                f.write(f">asm\n{asm}\n")
        return cache["asm"]

    def drive(what: str, fn) -> dict[str, int]:
        """One run of a main path with every launch counter set to 0 just
        before it and read just after; fails unless each of the path's
        kernels launched."""
        for fn_, attr in counters.values():
            setattr(fn_, attr, 0)
        fn()
        torch.cuda.synchronize()
        got = {k: getattr(fn_, attr) for k, (fn_, attr) in counters.items()}
        print(f"{what}: launches {got}")
        return got

    def same_files(d1: str, d2: str, what: str) -> None:
        for name in tsvs:
            with open(os.path.join(d1, name), "rb") as f1, open(os.path.join(d2, name), "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"{what}: {name} differs")

    def n_rows(d: str) -> int:
        with open(os.path.join(d, tsvs[0])) as f:
            return sum(1 for _ in f)

    def setup():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        print(smi)
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
        t0 = time.perf_counter()
        path = build.library_path()
        fresh = not path.exists()
        build.library()
        print(f"kernel build: {time.perf_counter() - t0:.2f} s ({'built' if fresh else 'cached'}) -> "
              f"{os.path.relpath(path, HERE)}")
        entry = "?"
        for ln in (path.parent / "build.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '_ZN\w*?_cu_\w{8}\d+([a-z_0-9]+)(I\w*?EE)?", ln)
            if m:
                entry = m.group(1) + (m.group(2) or "")
            elif "registers" in ln or "spill" in ln or "error" in ln:
                print(f"  ptxas: {entry}: {ln.strip()}")
        # the reused host formatter builds on first use too; build it here so
        # that the golden timing below measures the run, not g++
        from stringdecomposer_tpu_torch.runtime.native import load_native

        t0 = time.perf_counter()
        native = load_native() is not None
        print(f"native host library: {'ready' if native else 'unavailable (Python fallbacks)'} "
              f"in {time.perf_counter() - t0:.2f} s")

    def mono_set(records):
        monos = add_reverse_complement(records)
        L = (max(len(m.seq) for m in monos) + 7) // 8 * 8
        return monos, pad_monomers(monos, pad_to=L)

    def plan_at(M, L, state_bytes, windows):
        """The cluster plan chain_dp_large_cuda takes for `windows` windows
        on this card."""
        return k1.cluster_plan(M, L, state_bytes, windows,
                               lambda cs: k1.cluster_occupancy(M, L, state_bytes, cs, windows))

    def large_name(M, L, state_bytes, cluster_size=None):
        """The kernel name of the body chain_dp_large_cuda runs."""
        cluster = cluster_size is not None or k1.cluster_plan(M, L, state_bytes) is not None
        kind = ("cluster_tiled" if L > k1.LANES_MAX_L else "cluster") if cluster else "large"
        return k1_name(kind, L, state_bytes)

    plain_memo: dict = {}

    def plain_k1(key, args, kw, state_dtype):
        """The plain twin's outputs on these inputs, run once a `key` (the
        inputs' digest): K1's routes and cluster sizes are held to one run
        of it. k1_checks empties the memo when it ends."""
        if (key, state_dtype) not in plain_memo:
            plain_memo[key, state_dtype] = k1_plain.chain_dp_forward(
                *args, state_dtype=state_dtype, **kw)
        return plain_memo[key, state_dtype]

    def k1_int16_case(args, kw, lens_np, what, cluster_size, key):
        """K1's int16 state on both routes (the large one at `cluster_size`
        where given) against the int16 twin (every output, the debug arrays
        too) and against the int32 kernel (blocks, counts, and end / spend on
        the rows of nonzero length)."""
        M, L = args[2].shape[-2], args[2].shape[-1]
        shared16 = k1_name(k1_body(M, L, 2), L, 2)
        b32, c32, (_, e32, s32) = chain_dp_forward_cuda(*args, **kw)
        want = plain_k1(key, args, kw, "int16")
        real = torch.from_numpy(lens_np > 0).to(dev)
        real = real[None, None, :] if real.dim() == 1 else real[:, None, :]
        got = None
        for fn, kernel, fkw in ((chain_dp_forward_cuda, shared16, {}),
                                (chain_dp_large_cuda, large_name(M, L, 2, cluster_size),
                                 {"cluster_size": cluster_size})):
            got = fn(*args, state_dtype="int16", **fkw, **kw)
            torch.cuda.synchronize()
            bk, ck, (chk, ek, sk) = got
            for nm, g, w in zip(("blocks", "counts", "chain", "end", "spend"),
                                (bk, ck, chk, ek, sk), want[:2] + want[2]):
                smoke.same(kernel, f"{what} int16 {nm} vs the int16 twin", g, w)
            smoke.same(kernel, f"{what} int16 blocks vs the int32 kernel", bk, b32)
            smoke.same(kernel, f"{what} int16 counts vs the int32 kernel", ck, c32)
            smoke.same(kernel, f"{what} int16 end (real rows) vs int32", torch.where(real, ek, e32), e32)
            smoke.same(kernel, f"{what} int16 spend (real rows) vs int32",
                       torch.where(real, sk, s32), s32)
        return got

    def k1_case(windows_np, wlens_np, mono_np, lens_np, sc, what, max_blocks=0,
                fn=chain_dp_forward_cuda, kernel=None, want=None, int16=False,
                cluster_size=None, body=None):
        """One K1 route (`fn`, whose errors count under `kernel`, by default
        the body chain_dp_forward_cuda takes; chain_dp_large_cuda at
        `cluster_size` where given; the body `body` names where given)
        against the plain twin, or against `want` when given (another route's
        outputs on the same inputs). Returns the kernel's outputs. With
        int16, both routes' int16 state instead (k1_int16_case)."""
        arrays = (windows_np, wlens_np, mono_np, lens_np)
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        kernel = kernel or k1_name(k1_body(*mono_np.shape[-2:]), mono_np.shape[-1], 4)
        kw = dict(ins=sc[0], dele=sc[1], mismatch=sc[2], match=sc[3],
                  max_blocks=max_blocks, return_debug=True)
        key = hashlib.sha256(repr([(a.shape, a.dtype.str) for a in arrays] + sorted(kw.items()))
                             .encode() + b"".join(a.tobytes() for a in arrays)).hexdigest()
        if int16:
            return k1_int16_case(args, kw, lens_np, what, cluster_size, key)
        extra = {k: v for k, v in (("cluster_size", cluster_size), ("force_body", body))
                 if v is not None}
        got = fn(*args, **extra, **kw)
        if want is None:
            want = plain_k1(key, args, kw, "auto")
        torch.cuda.synchronize()
        (bk, ck, (chk, ek, sk)), (bp, cp, (chp, ep, spp)) = got, want
        smoke.same(kernel, f"{what} end", ek, ep)
        smoke.same(kernel, f"{what} spend", sk, spp)
        smoke.same(kernel, f"{what} chain", chk, chp)
        smoke.same("block_walk", f"{what} blocks", bk, bp)
        smoke.same("block_walk", f"{what} counts", ck, cp)
        return got

    def k1_checks(int16=False):
        """K1 on the fixtures, random shapes, the library and the dimer and
        trimer variants; int16 runs the same cases through the int16 state
        of both routes."""
        import numpy.random as npr

        plain_memo.clear()

        mode = "int16" if int16 else "int32"
        cases = []
        for name in ("random_cases.json", "random_cases_b.json"):
            with open(os.path.join(FIXTURES, name)) as f:
                cases.extend(json.load(f))
        n_win = 0
        for idx, case in enumerate(cases):
            monos, (mono, lens) = mono_set([Record(n, s) for n, s in case["monomers"]])
            reads = case.get("reads") or [["read0", case["read"]]]
            wins = [encode(seq[o : o + ln]) for _, seq in reads
                    for o, ln in make_windows(len(seq), case["part_size"], case["overlap"])]
            wb, wl = k1_plain.build_window_batch(wins, max(len(w) for w in wins))
            k1_case(wb, wl, mono, lens, case["scoring"], f"fixture {idx}", int16=int16)
            n_win += len(wins)
            if int16:
                continue
            cfg = pipeline.PipelineConfig(scoring=Scoring(*case["scoring"]),
                                          part_size=case["part_size"],
                                          overlap=case["overlap"], device_batch=3)
            res = pipeline.decompose_reads([Record(n, s) for n, s in reads], monos, cfg, "cuda")
            names = [m.name for m in monos]
            raw = "".join(r + "\n" for rn, b in res for r in format_raw_rows(rn, b, names))
            if raw != case["raw"]:
                raise AssertionError(f"fixture {idx}: raw TSV differs from the reference binary")
        print(f"K1 {mode}: {len(cases)} fixture cases ({n_win} windows) bit-equal to the plain "
              f"twin{'' if int16 else '; raw strings equal to the reference binary' + chr(39) + 's'}")
        rng = npr.default_rng(7)
        alpha = np.array(list("ACGT"))

        def rand_monos(M2, lo, hi):
            """M2 random monomers of lengths in [lo, hi), the first of hi - 1."""
            return [Record(f"m{j}", "".join(rng.choice(
                alpha, hi - 1 if j == 0 else int(rng.integers(lo, hi))))) for j in range(M2)]

        def rand_windows(fwd, B, W):
            wins = []
            for _ in range(B):
                unit = fwd[int(rng.integers(len(fwd)))].seq
                arr = np.array(list((unit * (W // len(unit) + 2))[: int(rng.integers(W // 2, W + 1))]))
                idx = rng.integers(0, len(arr), max(1, len(arr) // 10))
                arr[idx] = rng.choice(alpha, len(idx))
                wins.append(encode("".join(arr)))
            return k1_plain.build_window_batch(wins, W)

        # (what, forward monomers, lengths [lo, hi), rows kept, B, W): the
        # lanes body with its rows in registers (M <= 32: one row a warp up
        # to C = 8, two above, an odd M leaving the last warp one) and in
        # shared memory (M >= 33, with L a multiple of 32 or not), at C = 1
        # (L = 8), 8 (L = 256), 10, 12 and 16 (L = 512), up to the int32
        # shared limit (M = 133 at L = 192); the tiled body at L = 544 (a warp
        # a row, C = 17) and 1,040 (two rows, each over two warps)
        shapes = [("golden-like M=24 L=192", 12, 150, 188, 24, 6, 1200),
                  ("M=128 L=40 W=96", 64, 20, 41, 128, 4, 96),
                  ("M=128 L=192", 64, 150, 190, 128, 3, 600),
                  ("M=32 L=192", 16, 150, 190, 32, 3, 600),
                  ("M=33 L=192", 17, 150, 190, 33, 3, 600),
                  ("M=24 L=256", 12, 200, 257, 24, 3, 1000),
                  ("M=24 L=8", 12, 3, 9, 24, 3, 300),
                  ("M=133 L=192", 67, 150, 190, 133, 2, 600),
                  ("M=40 L=176", 20, 150, 177, 40, 3, 600),
                  ("M=20 L=320", 10, 280, 321, 20, 3, 1300),
                  ("M=17 L=304", 9, 260, 301, 17, 2, 1216),
                  ("M=16 L=512", 8, 400, 513, 16, 2, 2048),
                  ("M=33 L=360", 17, 300, 358, 33, 2, 1440),
                  ("M=40 L=384", 20, 320, 385, 40, 2, 1536),
                  ("M=20 L=544 (tiled body)", 10, 500, 545, 20, 2, 2176),
                  ("M=2 L=1040 (tiled body, 2 warps a row)", 1, 1000, 1041, 2, 2, 2200)]
        # the shapes on which the large route is also held to the shared one,
        # and those on which the tiled body is held to the lanes body
        shapes_vs_large = [what for what, *_ in shapes[:3]] + ["M=17 L=304",
                                                               "M=20 L=544 (tiled body)"]
        tiled_vs_lanes = ("M=33 L=360", "M=16 L=512")
        if int16:  # shared route in int16, large route in int32
            shapes.append(("M=200 L=192", 100, 150, 190, 200, 3, 768))
        for what, nf, lo, hi, rows, B, W in shapes:
            fwd = rand_monos(nf, lo, hi)
            _, (mono, lens) = mono_set(fwd)
            mono, lens = mono[:rows], lens[:rows]
            wb, wl = rand_windows(fwd, B, W)
            k1_case(wb, wl, mono, lens, (-1, -1, -1, 1), what, int16=int16)
            # per-window [B, M, L] form: a different monomer order per
            # window, and the last rows masked to length 0
            perm = np.stack([rng.permutation(len(lens)) for _ in range(B)])
            mono_w, lens_w = mono[perm], lens[perm].copy()
            lens_w[:, -min(2, rows - 1):] = 0  # one row stays real: the sentinels differ by state
            if int(lens.max()) != hi - 1 or mono.shape[0] != rows:
                raise AssertionError(f"{what}: mono {mono.shape}, longest {int(lens.max())}")
            k1_case(wb, wl, mono_w, lens_w, (-2, -1, -1, 2), what + " per-window", int16=int16)
            if int16:  # the int16 state's overflow runs at the library and the variants below
                continue
            counts = k1_case(wb, wl, mono, lens, (-1, -2, -1, 1), what + " max_blocks=1",
                             max_blocks=1)[1]
            if int(counts.max()) <= 1:
                raise AssertionError(f"{what}: the overflow case did not overflow")
            if what in tiled_vs_lanes:  # the tiled body where the lanes body runs
                for mw, lw, sc in ((mono, lens, (-1, -1, -1, 1)),
                                   (mono_w, lens_w, (-2, -1, -1, 2))):
                    lanes = k1_case(wb, wl, mw, lw, sc, what + " lanes body")
                    k1_case(wb, wl, mw, lw, sc, f"{what} tiled body vs the lanes body",
                            kernel="chain_dp_tiled", want=lanes, body="tiled")
            if what not in shapes_vs_large:
                continue
            # the cluster body on a set that fits, against the lanes body (the
            # tiled cluster body against the tiled body past 512)
            for mw, lw, sc in ((mono, lens, (-1, -1, -1, 1)), (mono_w, lens_w, (-2, -1, -1, 2))):
                shared = k1_case(wb, wl, mw, lw, sc, what + " shared route")
                for cs in (2, 4):
                    k1_case(wb, wl, mw, lw, sc, f"{what} cluster body cs={cs} vs the shared one",
                            fn=chain_dp_large_cuda, kernel=large_name(*mw.shape[-2:], 4, cs),
                            want=shared, cluster_size=cs)
        # rows that end before a warp of the tiled bodies: per window two
        # rows of up to 1,040 bp, on the tiled body over 2 warps of 544 cells
        # a row and, at cs = 2 (a row a block), on the tiled cluster body
        # over 4 warps of 288; full rows beside rows that end before the
        # second, third or fourth warp, at and just past a warp's first
        # cell, and of length 0
        if k1.tiled_layout(2, 1040)[:2] != (2, 17) or k1.tiled_layout(1, 1040)[:2] != (4, 9):
            raise AssertionError(f"tiled layouts at L = 1,040: {k1.tiled_layout(2, 1040)}, "
                                 f"{k1.tiled_layout(1, 1040)}")
        fwd = rand_monos(2, 1000, 1041)
        _, (mono, _) = mono_set(fwd)
        short = np.array([[1040, 300], [288, 1040], [543, 545], [864, 865], [1, 0]], np.int32)
        mono_s = np.ascontiguousarray(np.broadcast_to(mono[:2], (len(short), 2, 1040)))
        wb, wl = rand_windows(fwd, len(short), 600)
        k1_case(wb, wl, mono_s, short, (-2, -1, -1, 2), "M=2 L=1040 rows ending before a warp",
                int16=int16, cluster_size=2 if int16 else None)
        if not int16:
            k1_case(wb, wl, mono_s, short, (-2, -1, -1, 2), "M=2 L=1040 rows ending before a "
                    "warp, cs=2", fn=chain_dp_large_cuda, kernel=large_name(2, 1040, 4, 2),
                    cluster_size=2)
        print(f"K1 {mode}: rows ending before a warp (per-window rows of 0-1,040 bp) on the "
              "tiled body (G = 2, C = 17) and the tiled cluster body at cs = 2 (G = 4, C = 9) "
              "bit-equal to the plain twin")
        print(f"K1 {mode}: random shapes (shared and per-window monomers; M = 24, 32, 33, 128, "
              "133 at L = 192, L = 8, 40, 176, 256, 304, 320, 360, 384, 512 on the lanes body, "
              "L = 544 and 1,040 on the tiled body) bit-equal to the plain twin" + (
                  "" if int16 else
                  "; max_blocks=1 overflow; the cluster body at cs = 2 and 4 bit-equal to the "
                  "lanes body on M = 24 and 128 at L = 192 and M = 17 at L = 304, the tiled "
                  "cluster body to the tiled body at L = 544, the tiled body to the lanes body "
                  "at L = 360 and 512"))
        # the cluster body: the HOR-scale library (M = 264 at L = 192, past
        # the shared route), its first 200 and 134 rows, at the plan's
        # cluster sizes for 3, 19 and 64 windows, at 2 and at a non-portable
        # 16 where the card schedules it; shared and per-window monomers,
        # rows of length 0 in the last block, max_blocks=1 overflow
        sb = 2 if int16 else 4
        monos, (mono, lens) = mono_set(library)
        if mono.shape != (264, 192) or k1_body(*mono.shape, sb) != "cluster":
            raise AssertionError(f"library: shape {mono.shape}, body {k1_body(*mono.shape, sb)}")
        wb, wl = rand_windows(library, 3, 768)
        perm = np.stack([rng.permutation(len(lens)) for _ in range(3)])
        held = []
        for M in (264, 200, 134):
            m, ln = mono[:M], lens[:M]
            m_w, ln_w = mono[perm[:, :M]], lens[perm[:, :M]].copy()
            ln_w[:, -5:] = 0
            ragged = ln.copy()
            ragged[-3:] = 0
            sizes = []  # the plan's at 3, 19 and 64 windows, then 2 and 16
            for cs in [plan_at(M, 192, sb, B)[0] for B in (3, 19, 64)] + [2, 16]:
                if cs not in sizes and k1.cluster_shape(M, 192, sb, cs) is not None \
                        and k1.cluster_occupancy(M, 192, sb, cs, 3) > 0:
                    sizes.append(cs)
            for cs in sizes:
                kern = dict(fn=chain_dp_large_cuda, kernel=k1_name("cluster", 192, sb),
                            cluster_size=cs, int16=int16)
                k1_case(wb, wl, m, ln, (-1, -1, -1, 1), f"library[:{M}] cs={cs}", **kern)
                k1_case(wb, wl, m_w, ln_w, (-2, -1, -1, 2), f"library[:{M}] cs={cs} per-window",
                        **kern)
                k1_case(wb, wl, m, ragged, (-1, -2, -1, 1), f"library[:{M}] cs={cs} rows of "
                        "length 0 in the last block", **kern)
                counts = k1_case(wb, wl, m, ln, (-1, -1, -1, 1), f"library[:{M}] cs={cs} "
                                 "max_blocks=1", max_blocks=1, **kern)[1]
                if int(counts.max()) <= 1:
                    raise AssertionError(f"library[:{M}]: the overflow case did not overflow")
            held.append(f"M={M} at cs {sizes}")
        print(f"K1 {mode}: the cluster body on the 264-monomer library and its first 200 and 134 "
              f"rows ({'; '.join(held)}), shared and per-window monomers, "
              "rows of length 0, max_blocks=1 overflow, bit-equal to the plain twin")
        # 150 DXZ1 dimer variants (L = 360): the cluster body at the plan's
        # sizes for 2 and 19 windows, and at 3 (rows in shared memory), 5 and
        # 16 where they fit and the card schedules them; 150 trimer variants
        # (L = 528): the tiled cluster body at the same sizes
        held = []
        for what, records, body in (("dimer variants", variants, "cluster"),
                                    ("trimer variants", trimer_variants, "cluster_tiled")):
            _, (mono, lens) = mono_set(records)
            M, L = mono.shape
            if k1_body(M, L, sb) != body:
                raise AssertionError(f"{what} {mono.shape}: body {k1_body(M, L, sb)}")
            wb, wl = rand_windows(records, 2, 4 * L)
            perm = np.stack([rng.permutation(len(lens)) for _ in range(2)])
            mono_w, lens_w = mono[perm], lens[perm].copy()
            lens_w[:, -4:] = 0
            sizes = [None]
            if body in ("cluster", "cluster_tiled"):
                sizes = []
                for cs in [plan_at(M, L, sb, B)[0] for B in (2, 19)] + [3, 5, 16]:
                    if cs not in sizes and k1.cluster_shape(M, L, sb, cs) is not None \
                            and k1.cluster_occupancy(M, L, sb, cs, 2) > 0:
                        sizes.append(cs)
            for cs in sizes:
                kern = dict(fn=chain_dp_large_cuda, kernel=k1_name(body, L, sb), int16=int16,
                            cluster_size=cs)
                tag = f"{what} M={M} L={L}" + (f" cs={cs}" if cs else "")
                k1_case(wb, wl, mono, lens, (-1, -1, -1, 1), tag, **kern)
                k1_case(wb, wl, mono_w, lens_w, (-2, -1, -1, 2), f"{tag} per-window", **kern)
                counts = k1_case(wb, wl, mono, lens, (-1, -1, -1, 1), f"{tag} max_blocks=1",
                                 max_blocks=1, **kern)[1]
                if int(counts.max()) <= 1:
                    raise AssertionError(f"{tag}: the overflow case did not overflow")
            held.append(f"{what} (L = {L}) on the {k1_name(body, L, sb)} body at cs {sizes}")
        print(f"K1 {mode}: {'; '.join(held)}: shared and per-window monomers, max_blocks=1 "
              "overflow, bit-equal to the plain twin")
        plain_memo.clear()

    def k2_checks():
        cases = []
        for name in ("edlib_cases.json", "edlib_cases_b.json"):
            with open(os.path.join(FIXTURES, name)) as f:
                cases.extend(json.load(f))

        def batch(strs):
            L = max(1, max(len(s) for s in strs))
            arr = np.full((len(strs), L), 7, dtype=np.int32)
            lens = np.array([len(s) for s in strs], dtype=np.int32)
            for i, s in enumerate(strs):
                arr[i, : len(s)] = np.frombuffer(s.encode(), dtype=np.uint8)
            return torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)

        def both(qs, ts, what):
            """Both entries against their plain twins: the pairwise entry on
            (qs[i], ts[i]), the cross entry on every qs[i] x ts[k]."""
            q, ql = batch(qs)
            t, tl = batch(ts)
            got = nw_identity_batch_cuda(q, ql, t, tl)
            want = k2_plain.nw_identity_batch(q, ql, t, tl)
            for name_, g, w in zip(("D", "matches", "columns"), got, want):
                smoke.same("nw_identity", f"{what} {name_}", g, w)
            cross = nw_identity_cross_cuda(q, ql, t, tl)
            smoke.same("nw_identity_cross", f"{what} (cross, {len(qs)} x {len(ts)})", cross,
                       k2_plain.nw_identity_cross(q, ql, t, tl))
            return [x.cpu().numpy() for x in got]

        D, mt, cols = both([c["q"] for c in cases], [c["t"] for c in cases], "edlib fixtures")
        for i, c in enumerate(cases):
            ops = re.findall(r"(\d+)([=XIDM])", c["cigar"])
            want = (int(c["ed"]), sum(int(n) for n, op in ops if op == "="),
                    sum(int(n) for n, _ in ops))
            if (int(D[i]), int(mt[i]), int(cols[i])) != want:
                raise AssertionError(f"edlib case {i}: got {(D[i], mt[i], cols[i])}, want {want}")
        print(f"K2: {len(cases)} edlib fixture cases equal to edlib (ed, matches, columns) "
              "and bit-equal to the plain twin through both entries (cross: every query x "
              "every target)")
        rng = np.random.default_rng(3)

        def rs(n):
            return "".join(rng.choice(list("ACGT"), n))

        qs = ["A", "", "ACGT" * 8, "G" * 17, "ACGT", rs(126), rs(1), rs(126), rs(4500)]
        ts = ["", "ACG", "ACGT" * 8, "G" * 16, "T", rs(1), rs(126), rs(128), rs(4200)]
        both(qs, ts, "edge lengths (tlen 0, qlen 0, skews, 4500 x 4200)")
        print("K2: edge lengths and a 4500 x 4200 pair (strip route, carry rows in device "
              "memory) bit-equal to the plain twins through both entries")
        # the seams of ops/identity.nw_lanes: per C, queries padded to 32 C
        # (the kernel's C) with the last lane's last row and a full lane
        # group; then the strips of 32 * C_MAX rows (their carry rows in
        # device memory), with short and with long targets
        for C in range(1, C_MAX + 1):
            R = 32 * C
            both([rs(n) for n in (R - 1, R, 1, 0, C, C + 1, int(rng.integers(1, R)))],
                 [rs(n) for n in (19, 1, 23, 5, 2, 0, int(rng.integers(1, 200)))], f"seams C={C}")
        S = 32 * C_MAX
        both([rs(n) for n in (S - 1, S, S + 1, 2 * S, 2 * S + 1, 3 * S - 1, 3 * S + 2, 40, 0)],
             [rs(n) for n in (50, 31, 32, 33, 60, 170, 1, 3, 5)], "strips, short targets")
        both([rs(n) for n in (1100, 900, S + 1)], [rs(n) for n in (2000, 1900, 1816)],
             "strips, long targets")
        print(f"K2: lane seams at C = 1..{C_MAX} and strip seams ({S}-row strips, 2 and 3 "
              "strips, short and long targets) bit-equal through both entries")
        # the cross entry at the library's width: golden blocks x 264 monomers
        _, (mlib, llib) = mono_set(library)
        codes = encode(load_fasta(read_fa)[0].seq)
        starts = np.sort(rng.choice(len(codes) - 300, 40, replace=False))
        blens = rng.integers(0, 260, 40).astype(np.int32)
        q = k2_plain.blocks_from_read(torch.from_numpy(codes).to(dev), torch.from_numpy(starts).to(dev),
                                      torch.from_numpy(blens).to(dev), int(blens.max()))
        ql = torch.from_numpy(blens).to(dev)
        t, tl = torch.from_numpy(mlib).to(dev), torch.from_numpy(llib).to(dev)
        smoke.same("nw_identity_cross", "40 read blocks (0-259 bp) x library M=264",
                   nw_identity_cross_cuda(q, ql, t, tl), k2_plain.nw_identity_cross(q, ql, t, tl))
        print("K2: the cross entry on 40 read blocks of 0-259 bp x the 264-monomer library "
              "bit-equal to the plain cross twin")
        # nw_identity_packed_both on the JAX package's packed test case
        rng = np.random.default_rng(23)
        alpha = list("ACGT")
        unit = "".join(rng.choice(alpha, 17))
        read = (unit * 40)[:600]
        blocks = [(5, 20), (100, 17), (0, 230), (40, 8), (300, 60), (100, 17), (550, 50), (7, 1)]
        starts = np.array([s for s, _ in blocks], dtype=np.int64)
        lens = np.array([n for _, n in blocks], dtype=np.int32)
        monos = ["".join(rng.choice(alpha, int(n))) for n in (17, 23, 11)]
        from stringdecomposer_tpu_torch.convert import pad_codes

        t_raw, tl_raw = (torch.from_numpy(a).to(dev) for a in pad_codes([encode(m) for m in monos]))
        t_homo, tl_homo = (torch.from_numpy(a).to(dev)
                           for a in pad_codes([encode(homo_compress(m)) for m in monos]))
        args = (torch.from_numpy(encode(read)).to(dev), starts, lens, t_raw, tl_raw, t_homo, tl_homo)
        smoke.same("nw_identity_cross", "packed_both",
                   nw_identity_packed_both(*args, n_pad=16, Lq=256),
                   k2_plain.nw_identity_packed_both_plain(*args, n_pad=16, Lq=256))
        print("K2: nw_identity_packed_both bit-equal to its plain version")

    golden = {}

    def golden_run():
        with tempfile.TemporaryDirectory() as out:
            res = {}

            def cli_run():
                t0 = time.perf_counter()
                res["rc"] = cli.main([read_fa, dxz1, "-o", out, "--second-best"])
                torch.cuda.synchronize()
                res["dt"] = time.perf_counter() - t0

            got = drive("golden CLI --second-best (kernel route)", cli_run)
            dt = res["dt"]
            if res["rc"] != 0:
                raise AssertionError(f"CLI exit code {res['rc']}")
            need = ("chain_dp_lanes", "block_walk", "nw_identity_cross")
            bad = [k for k in need if got[k] <= 0]
            if bad or got["nw_identity"]:
                raise AssertionError(f"golden --second-best: launches {got}")
            launches.update({k: got[k] for k in need})
            for got_f, want in (("final_decomposition_raw.tsv", "raw_decomposition_oracle.tsv"),
                                ("final_decomposition.tsv", "final_decomposition_fc89af8.tsv")):
                with open(os.path.join(out, got_f), "rb") as f1, open(os.path.join(DATA, want), "rb") as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"{got_f} differs from {want}")
            with open(os.path.join(out, "stringdecomposer.log")) as f:
                if "Thank you for using StringDecomposer!" not in f.read():
                    raise AssertionError("log sentinel missing")
            rows = n_rows(out)
            # the same run with four finishing threads sharing the card
            out4 = os.path.join(out, "t4")
            rc = cli.main([read_fa, dxz1, "-o", out4, "--second-best", "-t", "4"])
            if rc != 0:
                raise AssertionError(f"CLI -t 4 exit code {rc}")
            same_files(out, out4, "-t 4 against the -t 1 run")
            # light mode (no --second-best): each block against its best
            # monomer through the pairwise entry, against K2's plain twin
            light = os.path.join(out, "light")
            got = drive("golden CLI light mode (kernel route)",
                        lambda: res.update(rc=cli.main([read_fa, dxz1, "-o", light])))
            if res["rc"] != 0 or got["nw_identity"] <= 0 or got["nw_identity_cross"]:
                raise AssertionError(f"golden light mode: rc {res['rc']}, launches {got}")
            launches["nw_identity"] = got["nw_identity"]
            with open(os.path.join(light, "final_decomposition_raw.tsv"), "rb") as f1, \
                    open(os.path.join(DATA, "raw_decomposition_oracle.tsv"), "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError("light mode: raw TSV differs from raw_decomposition_oracle.tsv")
            pipeline.run(read_fa, dxz1, out_dir=os.path.join(out, "light_plain"), device="cuda",
                         identity_fn=k2_plain.nw_identity_batch)
            same_files(light, os.path.join(out, "light_plain"), "light mode, K2 kernel vs plain twin")
        golden.update(seconds=dt, rows=rows)
        path = {k: launches[k] for k in need}
        print(f"golden: raw TSV == raw_decomposition_oracle.tsv, final TSV == "
              f"final_decomposition_fc89af8.tsv (byte for byte); launches {path}; -t 4 run "
              "gives the same three TSVs; light mode (pairwise entry, "
              f"{launches['nw_identity']} launches) gives the oracle's raw TSV and the plain "
              "twin's three TSVs")
        print(f"golden: e2e {dt:.3f} s, {rows} assignments, {rows / dt:.1f} raw assignments/s "
              f"(first run in this process, kernels already built)")

    def joined_runs():
        """The golden read against the DXZ1 dimers and trimers, 150 variants
        of each, and the DXZ1 HOR unit (`--second-best`): the dimers through
        the CLI on K1's lanes body at L = 360, their variants on the cluster
        body, the trimers (L = 528) through the CLI on the tiled body, their
        variants on the tiled cluster body, the HOR unit (L = 2,056) through
        the CLI on the tiled body. Each run launches its K1 body and no
        other, and its three TSVs equal those of the plain route (the sets)
        or of the route with K1's plain twin (the variants). Then the ~17 kbp
        unit against two copies of itself (`decompose_reads`, unfiltered) on
        the tiled cluster body, its raw rows equal to the route with K1's
        plain twin."""
        from stringdecomposer_tpu_torch.ops.identity_cuda import cells_per_lane

        out = work.name
        bodies = ("chain_dp", "chain_dp_large", "chain_dp_lanes", "chain_dp_cluster",
                  "chain_dp_lanes_long", "chain_dp_cluster_long", "chain_dp_tiled",
                  "chain_dp_cluster_tiled")
        for what, body in (("dimers", "chain_dp_lanes_long"),
                           ("dimers variants", "chain_dp_cluster_long"),
                           ("trimers", "chain_dp_tiled"),
                           ("trimers variants", "chain_dp_cluster_tiled"),
                           ("hor unit", "chain_dp_tiled")):
            records, fa = joined[what]
            kernel_dir, plain_dir = (os.path.join(out, what.replace(" ", "_") + r)
                                     for r in ("_kernel", "_plain"))
            secs = {}

            def run():
                t0 = time.perf_counter()
                if what.endswith("variants"):
                    pipeline.run(read_fa, fa, out_dir=kernel_dir, second_best=True, device="cuda")
                else:
                    rc = cli.main([read_fa, fa, "-o", kernel_dir, "--second-best"])
                    if rc != 0:
                        raise AssertionError(f"CLI golden x {what} exit code {rc}")
                secs["kernel"] = time.perf_counter() - t0

            entry = "pipeline.run" if what.endswith("variants") else "CLI"
            got = drive(f"golden x DXZ1 {what} ({entry}, kernel route)", run)
            bad = [k for k in (body, "block_walk", "nw_identity_cross") if got[k] <= 0]
            if bad or any(got[k] for k in bodies if k != body):
                raise AssertionError(f"golden x {what}: launches {got}")
            launches[body] = got[body]
            t0 = time.perf_counter()
            plain_kw = dict(forward_fn=k1_plain.chain_dp_forward) if what.endswith("variants") \
                else plain_route
            pipeline.run(read_fa, fa, out_dir=plain_dir, second_best=True, device="cuda",
                         **plain_kw)
            torch.cuda.synchronize()
            same_files(kernel_dir, plain_dir, f"golden x {what}")
            _, (mono, _) = mono_set(records)
            with open(os.path.join(kernel_dir, tsvs[0])) as f:
                longest = max(int(r.split("\t")[3]) - int(r.split("\t")[2]) + 1 for r in f)
            other = "plain route" if plain_kw is plain_route else "route with K1's plain twin"
            print(f"golden x DXZ1 {what} (M={mono.shape[0]}, L={mono.shape[1]}, {body}): three "
                  f"TSVs equal to the {other}; "
                  f"{n_rows(kernel_dir)} assignments; kernel route {secs['kernel']:.3f} s, "
                  f"the other {time.perf_counter() - t0:.3f} s; K2 for the longest block "
                  f"({longest} bp): C = {cells_per_lane(longest)} rows a lane, "
                  f"{'strips' if longest > 32 * C_MAX else 'one strip'} of {32 * C_MAX} rows")
        reads, monos = wide_case()
        res = {}

        def unit_run():
            t0 = time.perf_counter()
            res["kernel"] = pipeline.decompose_reads(reads, monos, pipeline.PipelineConfig(),
                                                     "cuda")
            torch.cuda.synchronize()
            res["secs"] = time.perf_counter() - t0

        got = drive(f"{len(reads[0].seq)} bp x a {len(monos[0].seq)} bp unit (decompose_reads)",
                    unit_run)
        body = "chain_dp_cluster_tiled"
        if got[body] <= 0 or any(got[k] for k in bodies if k != body):
            raise AssertionError(f"17 kbp unit: K1 launches {got}")
        launches[body] = launches.get(body, 0) + got[body]
        t0 = time.perf_counter()
        res["plain"] = pipeline.decompose_reads(reads, monos, pipeline.PipelineConfig(), "cuda",
                                                forward_fn=k1_plain.chain_dp_forward)
        secs = time.perf_counter() - t0
        names = [m.name for m in monos]
        raw = {k: "".join(r + "\n" for rn, b in res[k] for r in format_raw_rows(rn, b, names))
               for k in ("kernel", "plain")}
        if raw["kernel"] != raw["plain"] or not raw["kernel"]:
            raise AssertionError("17 kbp unit: raw rows differ from the route with K1's plain twin")
        print(f"{len(reads[0].seq)} bp x {len(monos[0].seq)} bp unit (M={len(monos)}, {body}): "
              f"raw rows equal to the route with K1's plain twin; "
              f"{raw['kernel'].count(chr(10))} rows; kernel route {res['secs']:.3f} s, the "
              f"other {secs:.3f} s")

    def chunked_run():
        """K1's chunked body at the shapes it keeps, through
        chain_dp_forward_cuda on short windows, each against the plain twin:
        a row the tiled form cannot hold in one block (M = 1, L = 25,800 on
        the shared route: `chain_dp`), more rows than 16 blocks hold (800
        int32 rows of 528 bp: `chain_dp_large`; 1,400 int16 rows:
        `chain_dp_large_int16`), and, since the int16 range check leaves it
        no shared-route set, 20 rows of 544 bp with force_body="chunked"
        (`chain_dp_int16`)."""
        rng = np.random.default_rng(12)
        cases = (("M=1 L=25800", 1, 25800, 48, "int32", None, "chain_dp"),
                 ("M=800 L=528", 800, 528, 64, "int32", None, "chain_dp_large"),
                 ("M=1400 L=528 int16", 1400, 528, 64, "int16", None, "chain_dp_large_int16"),
                 ("M=20 L=544 int16, force_body='chunked'", 20, 544, 400, "int16", "chunked",
                  "chain_dp_int16"))
        inputs, outs = {}, {}
        for what, M, L, W, *_ in cases:
            lens = rng.integers(L // 2, L + 1, M).astype(np.int32)
            lens[0] = L
            mono = np.full((M, L), 5, dtype=np.int8)
            for m in range(M):
                mono[m, : lens[m]] = rng.integers(0, 4, lens[m])
            win = rng.integers(0, 4, (2, W)).astype(np.int8)
            wl = np.array([W, W - 7], dtype=np.int32)
            win[1, W - 7 :] = k1_plain.READ_PAD
            inputs[what] = [torch.from_numpy(a).to(dev) for a in (win, wl, mono, lens)]

        def path():
            for what, _, _, _, dt, body, _ in cases:
                outs[what] = chain_dp_forward_cuda(*inputs[what], return_debug=True,
                                                   state_dtype=dt, force_body=body)

        got = drive("K1's chunked body at the shapes it keeps (chain_dp_forward_cuda)", path)
        names = [name for *_, name in cases]
        if any(got[k] <= 0 for k in names) or any(
                got[k] for k in K1_BODY_NAMES if k not in names):
            raise AssertionError(f"chunked body: launches {got}")
        launches.update({k: got[k] for k in names})
        for what, _, _, _, dt, body, name in cases:
            (bk, ck, (chk, ek, sk)) = outs[what]
            p, (bp, cp, (chp, ep, spp)) = timed(lambda: k1_plain.chain_dp_forward(
                *inputs[what], return_debug=True, state_dtype=dt), 0)
            for nm, g, w in (("blocks", bk, bp), ("counts", ck, cp), ("chain", chk, chp),
                             ("end", ek, ep), ("spend", sk, spp)):
                smoke.same(name, f"{what} {nm}", g, w)
            # the kernels line's row: K1 + walk at this shape, the launch's own
            k, got = timed(lambda: chain_dp_forward_cuda(*inputs[what], state_dtype=dt,
                                                         force_body=body), 5)
            smoke.same(name, f"{what} timed blocks", got[0], bk)
            win, _, mono, lens = inputs[what]
            B, W = win.shape
            bd = k1_bound(win, mono, lens, 2 if dt == "int16" else 4, blocks_out=B * (W * 16 + 4))
            timing[name], bounds[name] = (statistics.median(k), p[0]), bd
            print(f"K1 {name} + walk, {what}, {B} windows x {W}: kernel {spread(k)}; plain "
                  f"{p[0]:.3f} ms; bound {bd[0]:.4f} ms ({bd[1]}), "
                  f"{100 * bd[0] / statistics.median(k):.2f} % of it")
        print("K1's chunked body: " + "; ".join(f"{what} ({name})" for what, *_, name in cases)
              + ": launched through chain_dp_forward_cuda, bit-equal to the plain twin")

    def scale_run():
        monomers_fwd = load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa"))
        asm = synthesize(1_600_000, monomers_fwd, np.random.default_rng(0))
        plain_route = dict(forward_fn=k1_plain.chain_dp_forward,
                           identity_fn=k2_plain.nw_identity_batch,
                           packed_fn=k2_plain.nw_identity_packed_both_plain)
        with tempfile.TemporaryDirectory() as td:
            fa = os.path.join(td, "asm.fa")
            with open(fa, "w") as f:
                f.write(f">asm\n{asm}\n")
            secs = {}
            for route, kw in (("kernel", {}), ("plain", plain_route)):
                t0 = time.perf_counter()
                pipeline.run(fa, os.path.join(DATA, "DXZ1_star_monomers.fa"),
                             out_dir=os.path.join(td, route), second_best=True, device="cuda", **kw)
                torch.cuda.synchronize()
                secs[route] = time.perf_counter() - t0
                print(f"scale 1.6 Mbp, {route} route: {inflight_depth()}")
            for name in ("final_decomposition_raw.tsv", "final_decomposition.tsv",
                         "final_decomposition_alt.tsv"):
                with open(os.path.join(td, "kernel", name), "rb") as f1, \
                        open(os.path.join(td, "plain", name), "rb") as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"1.6 Mbp: {name} differs between the routes")
            with open(os.path.join(td, "kernel", "final_decomposition_raw.tsv")) as f:
                n_rows = sum(1 for _ in f)
        print(f"scale 1.6 Mbp --second-best: three TSVs equal between routes; {n_rows} assignments; "
              f"kernel route {secs['kernel']:.3f} s ({n_rows / secs['kernel']:.1f}/s), "
              f"plain route {secs['plain']:.3f} s ({n_rows / secs['plain']:.1f}/s)")

    def k3_checks():
        rng = np.random.default_rng(11)
        k3_counters = ("launches", "launches_warp", "launches_wide")
        route_counter = dict(zip(k3_plain.ROUTES, k3_counters))

        def k3_launch(args, what, route="auto", seg_cols=None):
            """K3 on the card, held to the plain twin and to the mirror at the
            route and plan it took; exactly one launch, on that route."""
            L = args[2].shape[1]
            took = k3_plain.hw_route(L, route)
            before = [getattr(hw_distance_batch_cuda, c) for c in k3_counters]
            got = hw_distance_batch_cuda(*args, route=route, seg_cols=seg_cols)
            after = [getattr(hw_distance_batch_cuda, c) for c in k3_counters]
            want_launch = [int(c == route_counter[took]) for c in k3_counters]
            if [x - y for x, y in zip(after, before)] != want_launch:
                raise AssertionError(f"{what}: launches {before} -> {after} on the {took} route")
            name = "hw_filter" + ("" if took == "thread" else "_" + took)
            smoke.same(name, what, got, k3_plain.hw_distance_batch(*args))
            if seg_cols is None:
                seg_cols = 0 if took == "wide" else k3.plan(
                    args[0].shape[0], *args[2].shape, args[0].shape[1], 0, took)[2]
                seg_cols = 0 if seg_cols >= args[0].shape[1] else seg_cols
            smoke.same(name, what + " (mirror)", got,
                       k3_plain.hw_distance_myers(*args, route=took, seg_cols=seg_cols))
            return got

        def rand_case(B, W, M, L, alphabet=5):
            """Random codes (N included) with ragged lengths: the first
            window and monomer at full width, the last monomer of length 1."""
            win = np.full((B, W), k1_plain.READ_PAD, dtype=np.int8)
            wl = rng.integers(1, W + 1, B).astype(np.int32)
            wl[0] = W
            for b in range(B):
                win[b, : wl[b]] = rng.integers(0, alphabet, wl[b])
            mono = np.full((M, L), 5, dtype=np.int8)
            ml = rng.integers(1, L + 1, M).astype(np.int32)
            ml[0], ml[-1] = L, 1
            for m in range(M):
                mono[m, : ml[m]] = rng.integers(0, alphabet, ml[m])
            return [torch.from_numpy(a).to(dev) for a in (win, wl, mono, ml)]

        def sized_case(wlens, mlens, L, W):
            """Random codes, windows and monomers of the given lengths."""
            win = np.full((len(wlens), W), k1_plain.READ_PAD, dtype=np.int8)
            for b, n in enumerate(wlens):
                win[b, :n] = rng.integers(0, 5, n)
            mono = np.full((len(mlens), L), 5, dtype=np.int8)
            for m, n in enumerate(mlens):
                mono[m, :n] = rng.integers(0, 5, n)
            return [torch.from_numpy(a).to(dev) for a in
                    (win, np.asarray(wlens, np.int32), mono, np.asarray(mlens, np.int32))]

        shapes = [(3, 70, 5, 24), (4, 1, 6, 9), (2, 333, 17, 1), (5, 401, 24, 192),
                  (3, 257, 11, 512), (2, 150, 4, 700), (8, 1000, 13, 130)]
        for B, W, M, L in shapes:
            k3_launch(rand_case(B, W, M, L), f"random B={B} W={W} M={M} L={L}")
        print(f"K3: {len(shapes)} random shapes (window length 1, monomer length 1, N codes, "
              "L = 512 on the thread route, 700 on the warp route) bit-equal to the plain twin "
              "and the mirror")
        # the word seams (R = 1, 2, 3, 16 words a thread; 513 on the warp
        # route), every route that holds L at the card's plan and at forced
        # segments; windows shorter than the monomers and past them
        n = 0
        for L in (1, 31, 32, 33, 63, 64, 65, 511, 512, 513):
            mlens = sorted({L, max(1, L - 1), 1, int(rng.integers(1, L + 1))}, reverse=True)
            args = sized_case([600, 1, 33, 17, 1100], mlens, L, 1100)
            for route in k3_plain.ROUTES:
                if route == "thread" and L > k3_plain.THREAD_MAX_L:
                    continue
                for sc in (None, 0, 16, 48) if route != "wide" else (None,):
                    k3_launch(args, f"seam L={L} {route} seg_cols={sc}", route, sc)
                    n += 1
        # window lengths at a segment multiple and one either side, and
        # windows shorter than a monomer's warm-up, cut into segments
        for S in (16, 32, 64):
            wlens = [1, S - 1, S, S + 1, 2 * S - 1, 2 * S, 2 * S + 1, 3 * S + 1, 45]
            args = sized_case(wlens, [40, 24, 7, 1], 40, 3 * S + 8)
            for route in ("thread", "warp"):
                k3_launch(args, f"segment edges S={S} {route}", route, S)
                n += 1
        # all N: N matches N, READ_PAD nothing
        win = np.full((2, 600), k1_plain.READ_PAD, dtype=np.int8)
        win[0], win[1, :300] = 4, 4
        mono = np.full((2, 520), 5, dtype=np.int8)
        mono[0], mono[1, :100] = 4, 4
        args = [torch.from_numpy(a).to(dev) for a in (win, np.array([600, 300], np.int32), mono,
                                                       np.array([520, 100], np.int32))]
        for route in ("warp", "wide"):
            got = k3_launch(args, f"all N {route}", route).cpu().tolist()
            if got != [[0, 0], [220, 0]]:
                raise AssertionError(f"all N on the {route} route: {got}")
        # codes outside 0-4 (READ_PAD, 7, negative) in monomers and windows
        # compare as equal codes: the kernels' slow path
        odd = np.array([0, 1, 2, 3, 4, k1_plain.READ_PAD, 7, -3], dtype=np.int8)
        for L, routes in ((40, ("thread", "warp", "wide")), (600, ("warp", "wide"))):
            args = [torch.from_numpy(a).to(dev) for a in (
                rng.choice(odd, (3, 700)), np.array([700, 333, 5], np.int32),
                rng.choice(odd, (3, L)), np.array([L, L // 2, 1], np.int32))]
            for route in routes:
                for sc in (None, 16) if route != "wide" else (None,):
                    k3_launch(args, f"codes outside 0-4 L={L} {route} seg_cols={sc}", route, sc)
                    n += 1
        print(f"K3: {n} seam, segment-edge and odd-code launches (L = 1 .. 600, every route, "
              "the card's plan and forced segments, codes outside 0-4) and all-N windows "
              "bit-equal to the plain twin and the mirror")
        # past the warp route's 16,384 bp: the wide route, in one band of
        # stages and past 131,072 bp in two
        k3_launch(rand_case(2, 600, 2, 16400), "wide L=16400")
        if k3_plain.wide_shape(131100)[1] != 2:
            raise AssertionError(f"wide L=131100: {k3_plain.wide_shape(131100)}, not two bands")
        k3_launch(rand_case(2, 300, 2, 131100), "wide L=131100, two bands")
        print("K3: one launch on each route (thread, warp at L = 513 .. 2,000, wide at L = "
              "16,400 and at 131,100 in two bands), each counted on its own counter")
        cases = []
        for name in ("edlib_cases.json", "edlib_cases_b.json"):
            with open(os.path.join(FIXTURES, name)) as f:
                cases.extend(json.load(f))
        qs, ts = [c["q"] for c in cases], [c["t"] for c in cases]
        wb, wl = k1_plain.build_window_batch([encode(t) for t in ts], max(map(len, ts)))
        mono, lens = pad_monomers([Record(f"q{i}", q) for i, q in enumerate(qs)])
        args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
        got = k3_launch(args, "edlib cases all pairs")
        diag = got.diagonal().cpu().numpy()
        for i, (q, t) in enumerate(zip(qs, ts)):
            if int(diag[i]) != hw_brute(q, t):
                raise AssertionError(f"edlib case {i}: K3 {int(diag[i])}, brute force {hw_brute(q, t)}")
        print(f"K3: {len(cases)} x {len(cases)} edlib fixture pairs (L = {mono.shape[1]}, the "
              f"{k3_plain.hw_route(mono.shape[1])} route) bit-equal to the plain twin, the "
              "matching pairs equal to a brute-force infix DP")
        codes = encode(load_fasta(assembly_fa())[0].seq)
        wins = [codes[o : o + n] for o, n in make_windows(len(codes), 5000, 500)][:64]
        wb, wl = k1_plain.build_window_batch(wins, 5500)
        _, (mono, lens) = mono_set(library)
        args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
        dist = k3_launch(args, "64 windows x 5500 x library")
        dist_np = dist.cpu().numpy()
        for thr in (0, 3, 10, 1000):
            mono_w, lens_w, perm = k3_plain.filter_monomers_device(dist, args[2], args[3], thr)
            mono_w, lens_w, perm = (x.cpu().numpy() for x in (mono_w, lens_w, perm))
            kept = []
            for b in range(len(wins)):
                keep = k3_plain.filter_monomers(dist_np[b], thr)
                n = len(keep)
                kept.append(n)
                if not (np.array_equal(perm[b, :n], keep) and np.array_equal(lens_w[b, :n], lens[keep])
                        and not lens_w[b, n:].any() and np.array_equal(mono_w[b, :n], mono[keep])):
                    raise AssertionError(f"filter_monomers_device, ed_thr {thr}, window {b}")
            print(f"filter on the card == host filter at ed_thr {thr}: rows kept per window "
                  f"{min(kept)}-{max(kept)} of {len(lens)}")
        print(f"K3: 64 windows x 5500 x the 264-monomer library (plan "
              f"{k3.plan(64, *mono.shape, 5500, 0)}) bit-equal to the plain twin and the mirror")

    def ed_thr_run():
        cases = []
        for name in ("ed_thr_cases.json", "ed_thr_cases_b.json"):
            with open(os.path.join(FIXTURES, name)) as f:
                cases.extend(json.load(f))
        for idx, case in enumerate(cases):
            monos = add_reverse_complement([Record(n, q) for n, q in case["monomers"]])
            cfg = pipeline.PipelineConfig(scoring=Scoring(*case["scoring"]),
                                          part_size=case["part_size"], overlap=case["overlap"],
                                          device_batch=3, ed_thr=case["ed_thr"])
            res = pipeline.decompose_reads([Record("read0", case["read"])], monos, cfg, "cuda")
            names = [m.name for m in monos]
            raw = "".join(r + "\n" for rn, b in res for r in format_raw_rows(rn, b, names))
            if raw != case["raw"]:
                raise AssertionError(f"ed_thr fixture {idx}: raw TSV differs from the reference binary")
        print(f"ed_thr: {len(cases)} fixture cases on cuda equal to the reference binary's raw TSV")
        out = work.name
        secs = {}

        def cli_run():
            t0 = time.perf_counter()
            rc = cli.main([read_fa, dxz1, "-o", os.path.join(out, "i_kernel"), "--second-best",
                           "--ed_thr", "10"])
            secs["i"] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"CLI --ed_thr 10 exit code {rc}")

        got = drive("run (i) golden x DXZ1 --ed_thr 10 (CLI, kernel route)", cli_run)
        bad = [k for k in ("hw_filter", "chain_dp_lanes", "block_walk", "nw_identity_cross")
               if got[k] <= 0]
        if bad:
            raise AssertionError(f"run (i): kernels of the path not launched: {bad}")
        launches["hw_filter"] = got["hw_filter"]
        t0 = time.perf_counter()
        pipeline.run(read_fa, dxz1, out_dir=os.path.join(out, "i_plain"), second_best=True,
                     device="cuda", ed_thr=10, **plain_route)
        torch.cuda.synchronize()
        same_files(os.path.join(out, "i_kernel"), os.path.join(out, "i_plain"), "run (i)")
        print(f"run (i): three TSVs equal between routes; {n_rows(os.path.join(out, 'i_kernel'))} "
              f"assignments; kernel route {secs['i']:.3f} s, plain route "
              f"{time.perf_counter() - t0:.3f} s")
        for ed in (10, -1):
            for name, kw in (("kernel", {}), ("plain", plain_route)):
                d = os.path.join(out, f"ii_{ed}_{name}")
                t0 = time.perf_counter()
                pipeline.run(read_fa, library_fa, out_dir=d, second_best=True, device="cuda",
                             ed_thr=ed, **kw)
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
            same_files(os.path.join(out, f"ii_{ed}_kernel"), os.path.join(out, f"ii_{ed}_plain"),
                       f"run (ii) ed_thr {ed}")
            print(f"run (ii) golden x library --ed_thr {ed}: three TSVs equal between routes; "
                  f"{n_rows(os.path.join(out, f'ii_{ed}_kernel'))} assignments; kernel route "
                  f"{secs['kernel']:.3f} s, plain route {secs['plain']:.3f} s")

    def wide_case():
        """A macrosatellite-like workload past the K3 warp route's 16,384 bp:
        one unit of 100 DXZ1 monomers (~17 kbp, `workloads.joined_set`) and
        a read of two copies of it with 1 % of bases substituted (seed 0)."""
        unit = joined_set(load_fasta(dxz1), 100)[0]
        r = np.random.default_rng(0)
        seq = np.array(list(unit.seq * 2))
        hit = r.choice(len(seq), len(seq) // 100, replace=False)
        seq[hit] = [("ACGT".replace(c, ""))[int(r.integers(3))] for c in seq[hit]]
        return [Record("read_x2", "".join(seq))], add_reverse_complement([Record("dxz1_x100", unit.seq)])

    def ed_thr_long():
        """--ed_thr past the thread route: the golden read against the DXZ1
        trimers (CLI, L = 528: K3's warp route) and the ~17 kbp unit against
        two copies of itself (decompose_reads: the wide route), each with
        output equal to the route with K3's plain twin."""
        out = work.name
        fa = joined["trimers"][1]
        d = {r: os.path.join(out, f"trimers_ed_{r}") for r in ("kernel", "plain")}

        def cli_run():
            rc = cli.main([read_fa, fa, "-o", d["kernel"], "--second-best", "--ed_thr", "10"])
            if rc != 0:
                raise AssertionError(f"CLI trimers --ed_thr 10 exit code {rc}")

        got = drive("golden x DXZ1 trimers --ed_thr 10 (CLI, kernel route)", cli_run)
        if got["hw_filter_warp"] <= 0 or got["hw_filter"] or got["hw_filter_wide"]:
            raise AssertionError(f"trimers --ed_thr 10: K3 launches {got}")
        launches["hw_filter_warp"] = got["hw_filter_warp"]
        pipeline.run(read_fa, fa, out_dir=d["plain"], second_best=True, device="cuda", ed_thr=10,
                     hw_fn=k3_plain.hw_distance_batch)
        torch.cuda.synchronize()
        same_files(d["kernel"], d["plain"], "trimers --ed_thr 10")
        print(f"golden x DXZ1 trimers --ed_thr 10: K3's warp route, three TSVs equal to the route "
              f"with K3's plain twin; {n_rows(d['kernel'])} assignments")
        reads, monos = wide_case()
        cfg = pipeline.PipelineConfig(ed_thr=10)
        res = {}

        def wide_run():
            res["kernel"] = pipeline.decompose_reads(reads, monos, cfg, "cuda")

        got = drive(f"{len(reads[0].seq)} bp x a {len(monos[0].seq)} bp unit --ed_thr 10 "
                    "(decompose_reads)", wide_run)
        if got["hw_filter_wide"] <= 0 or got["hw_filter"] or got["hw_filter_warp"]:
            raise AssertionError(f"wide --ed_thr 10: K3 launches {got}")
        launches["hw_filter_wide"] = got["hw_filter_wide"]
        res["plain"] = pipeline.decompose_reads(reads, monos, cfg, "cuda",
                                                hw_fn=k3_plain.hw_distance_batch)
        names = [m.name for m in monos]
        raw = {k: "".join(r + "\n" for rn, b in v for r in format_raw_rows(rn, b, names))
               for k, v in res.items()}
        if raw["kernel"] != raw["plain"] or not raw["kernel"]:
            raise AssertionError("wide --ed_thr 10: raw rows differ from the route with K3's plain twin")
        print(f"{len(reads[0].seq)} bp x {len(monos[0].seq)} bp unit --ed_thr 10: K3's wide route, "
              f"raw rows equal to the route with K3's plain twin; {raw['kernel'].count(chr(10))} rows")

    def library_run():
        fa = assembly_fa()
        for ed in (10, -1):
            d = os.path.join(work.name, f"iii_{ed}")
            secs = {}

            def run_iii(d=d, ed=ed):
                t0 = time.perf_counter()
                pipeline.run(fa, library_fa, out_dir=d, second_best=True, device="cuda", ed_thr=ed)
                torch.cuda.synchronize()
                secs["e2e"] = time.perf_counter() - t0

            got = drive(f"run (iii) 1.6 Mbp x library --ed_thr {ed}", run_iii)
            print(f"run (iii) --ed_thr {ed}: {inflight_depth()}")
            path = ("hw_filter", "chain_dp_lanes") if ed >= 0 else ("chain_dp_cluster",)
            bad = [k for k in path + ("block_walk", "nw_identity_cross") if got[k] <= 0]
            if bad or got["chain_dp_large"]:
                raise AssertionError(f"run (iii) ed_thr {ed}: kernels of the path not launched: "
                                     f"{bad}, or the chunked large route launched: {got}")
            if ed < 0:
                launches["chain_dp_cluster"] = got["chain_dp_cluster"]
                # the same run with K1's plain twin in place of the cluster body
                t0 = time.perf_counter()
                pipeline.run(fa, library_fa, out_dir=d + "_plain", second_best=True, device="cuda",
                             forward_fn=k1_plain.chain_dp_forward)
                torch.cuda.synchronize()
                same_files(d, d + "_plain", "run (iii) unfiltered, K1 kernel vs plain twin")
                print(f"run (iii) unfiltered: three TSVs equal between the kernel route and the "
                      f"route with K1's plain twin ({time.perf_counter() - t0:.3f} s)")
            rows = n_rows(d)
            names = {r.name for r in library} | {r.name + "'" for r in library}
            with open(os.path.join(d, tsvs[0])) as f:
                used = {ln.split("\t")[1] for ln in f}
            # the assembly is ~9,400 monomer copies (1.6 Mbp / ~171 bp)
            if rows < 8000 or not used <= names:
                raise AssertionError(f"run (iii) ed_thr {ed}: {rows} rows, monomers {sorted(used - names)[:3]}")
            print(f"run (iii) 1.6 Mbp x library --ed_thr {ed} --second-best: e2e {secs['e2e']:.3f} s, "
                  f"{rows} assignments, {rows / secs['e2e']:.1f}/s, {len(used)} monomers used")

    def same_as_golden(d: str, what: str) -> None:
        for got_f, want in (("final_decomposition_raw.tsv", "raw_decomposition_oracle.tsv"),
                            ("final_decomposition.tsv", "final_decomposition_fc89af8.tsv")):
            with open(os.path.join(d, got_f), "rb") as f1, open(os.path.join(DATA, want), "rb") as f2:
                if f1.read() != f2.read():
                    raise AssertionError(f"{what}: {got_f} differs from {want}")

    def serve_jobs(jobs: list[str], *flags: str) -> tuple[list[dict], float, list[float]]:
        """`python -m stringdecomposer_tpu_torch --serve` as a subprocess on
        these job lines: the JSON status lines, the seconds from its start to
        the first job's start (Python, imports, CUDA context and whatever
        `flags` warm), and each job's seconds, from its log line `cmd:` to
        its status line, on this process's clock as the lines arrive."""
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "stringdecomposer_tpu_torch", "--serve",
                                 *flags], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                text=True, cwd=HERE, env={**os.environ, "PYTHONPATH": HERE})
        watchdog = threading.Timer(300, proc.kill)
        watchdog.start()
        status, starts, ends = [], [], []
        try:
            proc.stdin.write("".join(j + "\n" for j in jobs))
            proc.stdin.close()
            for line in proc.stdout:
                if " - SD-TPU - INFO - cmd: " in line:
                    starts.append(time.perf_counter())
                elif line.startswith("{"):
                    ends.append(time.perf_counter())
                    status.append(json.loads(line))
            rc = proc.wait()
        finally:
            watchdog.cancel()
            proc.kill()
            proc.wait()
        if rc != 0 or len(starts) != len(jobs) or len(status) != len(jobs):
            raise AssertionError(f"--serve: rc {rc}, {len(starts)} jobs started, statuses {status}")
        return status, starts[0] - t0, [e - b for b, e in zip(starts, ends)]

    def trace_busy(trace_dir: str) -> float:
        """Seconds of the union of device intervals (kernels, copies, sets)
        in the one torch.profiler trace under trace_dir."""
        (name,) = [n for n in os.listdir(trace_dir) if n.endswith(".pt.trace.json")]
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
        if not spans:
            raise AssertionError(f"{name}: no device events")
        busy, end = 0.0, -1.0
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy / 1e6

    def cli_ok(argv: list[str]) -> None:
        rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"CLI {' '.join(argv)}: exit code {rc}")

    def modes_run():
        """The golden read x DXZ1 through the CLI's one-GPU run modes:
        --stream-reads 1 on three reads against the one-shot run, --resume
        (no K1 launch), --serve --precompile (two jobs) and --profile-dir."""
        d = os.path.join(work.name, "modes")
        gold = load_fasta(read_fa)[0]
        three = os.path.join(work.name, "three.fa")
        write_fasta(three, [gold, Record("golden_copy", gold.seq), Record("short", gold.seq[:3000])])
        for what, extra in (("one", []), ("stream", ["--stream-reads", "1"])):
            got = drive(f"three reads x DXZ1 --second-best {' '.join(extra)}",
                        lambda: cli_ok([three, dxz1, "-o", os.path.join(d, what), "--second-best",
                                        *extra]))
            if got["chain_dp_lanes"] <= 0 or got["nw_identity_cross"] <= 0:
                raise AssertionError(f"{what}: kernels of the path not launched: {got}")
        same_files(os.path.join(d, "one"), os.path.join(d, "stream"),
                   "--stream-reads 1 against the one-shot run")
        print(f"--stream-reads 1, three reads (golden, a copy, 3,000 bp): three TSVs equal to the "
              f"one-shot run's ({n_rows(os.path.join(d, 'one'))} rows)")
        res = os.path.join(d, "resume")
        cli_ok([read_fa, dxz1, "-o", res, "--second-best"])
        with open(os.path.join(res, "final_decomposition_alt.tsv"), "rb") as f:
            alt = f.read()
        os.remove(os.path.join(res, "final_decomposition.tsv"))
        got = drive("golden --second-best --resume",
                    lambda: cli_ok([read_fa, dxz1, "-o", res, "--second-best", "--resume"]))
        k1_launched = {k: got[k] for k in K1_BODY_NAMES + ("block_walk",) if got[k]}
        if k1_launched or got["nw_identity_cross"] <= 0:
            raise AssertionError(f"--resume: K1 launched {k1_launched}, or K2 not: {got}")
        same_as_golden(res, "--resume")
        with open(os.path.join(res, "final_decomposition_alt.tsv"), "rb") as f:
            if f.read() != alt:
                raise AssertionError("--resume: alt TSV differs from the fresh run's")
        print(f"--resume: no K1 body or walk launched, nw_identity_cross {got['nw_identity_cross']}; "
              "raw and final TSVs equal to the golden TSVs, alt to the fresh run's")
        status, warm, job_s = serve_jobs(
            [f"{read_fa} {dxz1} -o {os.path.join(d, 's1')}",
                f"{read_fa} {dxz1} -o {os.path.join(d, 's2')} --ed_thr 10"],
            "--precompile", dxz1, "--second-best")
        if [x["status"] for x in status] != ["ok", "ok"]:
            raise AssertionError(f"--serve: {status}")
        same_as_golden(os.path.join(d, "s1"), "--serve job 1")
        ed10 = os.path.join(work.name, "i_plain")  # phase ed_thr: the plain route's run (i)
        same_files(os.path.join(d, "s2"), ed10, "--serve job 2 (--ed_thr 10) against the plain route")
        print(f"--serve --precompile DXZ1 --second-best: start-up and precompile {warm:.3f} s; job 1 "
              f"(golden) {job_s[0]:.3f} s, job 2 (golden --ed_thr 10) {job_s[1]:.3f} s; job 1's TSVs "
              "equal the golden TSVs, job 2's the plain route's")
        prof, trace = os.path.join(d, "prof"), os.path.join(d, "trace")
        walls = []
        for i in range(3):  # the same run unprofiled, warm, for the wall
            t0 = time.perf_counter()
            cli_ok([read_fa, dxz1, "-o", os.path.join(d, f"warm{i}"), "--second-best"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        cli_ok([read_fa, dxz1, "-o", prof, "--second-best", "--profile-dir", trace])
        same_as_golden(prof, "--profile-dir")
        busy = trace_busy(trace)
        print(f"--profile-dir, golden --second-best: TSVs equal to the golden TSVs; device busy "
              f"{busy:.4f} s (the trace's kernels, copies and sets) of the unprofiled run's median "
              f"{wall:.4f} s ({spread([1e3 * w for w in walls])}): busy {busy / wall:.3f}, idle "
              f"{1 - busy / wall:.3f}")

    def cli_procs(argvs: list[list[str]], timeout: float = 300) -> list[float]:
        """Each argv as `python -m stringdecomposer_tpu_torch` in its own
        process, all started together: each one's wall seconds from the
        common start to its exit. Fails unless every process exits 0; kills
        them all at `timeout` seconds."""
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "stringdecomposer_tpu_torch", *a],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  cwd=HERE, env={**os.environ, "PYTHONPATH": HERE})
                 for a in argvs]
        walls, outs = [0.0] * len(procs), [""] * len(procs)

        def wait(i):
            outs[i] = procs[i].communicate()[0]
            walls[i] = time.perf_counter() - t0

        waiters = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
        try:
            for w in waiters:
                w.start()
            for w in waiters:
                w.join(max(1.0, timeout - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for w in waiters:
                w.join()
        bad = [i for i, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError("; ".join(
                f"{' '.join(argvs[i])}: exit code {procs[i].returncode}\n{outs[i][-3000:]}"
                for i in bad))
        return walls

    def parallel_run():
        """Data parallelism and multi-host runs on the one card: the sharded
        functions (parallel/sharding.py) at [cuda:0] x 2 and x 3 against
        one call, bit-equal; the alignment API's row split against one
        device; the CLI with --data-parallel; two processes as two hosts
        (--num-hosts 2) and as a torch.distributed group (--coordinator)
        against one process; the reliability trainer on the card against
        the trainer on the CPU."""
        from stringdecomposer_tpu_torch.convert import numpy_state, pad_codes, state_from_numpy
        from stringdecomposer_tpu_torch.models import reliability as rel
        from stringdecomposer_tpu_torch.parallel.sharding import (
            make_sharded_forward, make_sharded_identity, make_sharded_packed,
        )

        d = os.path.join(work.name, "parallel")
        dev0 = torch.device("cuda", torch.cuda.current_device())
        gold = load_fasta(read_fa)[0]
        codes = encode(gold.seq)
        wins = [codes[o : o + n] for o, n in make_windows(len(codes), 5000, 500)]
        wb, wl = (torch.from_numpy(a).to(dev) for a in k1_plain.build_window_batch(wins, 5500))
        _, (mono_np, lens_np) = mono_set(load_fasta(dxz1))
        mono, lens = torch.from_numpy(mono_np).to(dev), torch.from_numpy(lens_np).to(dev)

        def same_forward(args, what):
            want = chain_dp_forward_cuda(*args)
            for n in (2, 3):
                got = drive(f"sharded K1 x {n}, {what}",
                            lambda: make_sharded_forward([dev0] * n)(*args))
                if not any(got[k] for k in K1_BODY_NAMES) or got["block_walk"] < n:
                    raise AssertionError(f"sharded K1 x {n}, {what}: launches {got}")
                out = make_sharded_forward([dev0] * n)(*args)
                smoke.same("block_walk", f"sharded K1 x {n}, {what}: blocks", out[0], want[0])
                smoke.same("block_walk", f"sharded K1 x {n}, {what}: counts", out[1], want[1])
            print(f"make_sharded_forward at [cuda:0] x 2 and x 3, {what}: blocks and counts "
                  "bit-equal to one chain_dp_forward_cuda call")

        same_forward((wb, wl, mono, lens), f"golden {len(wins)} windows x DXZ1 (M = 24)")
        _, (lib_np, llib_np) = mono_set(library)
        lib, llib = torch.from_numpy(lib_np).to(dev), torch.from_numpy(llib_np).to(dev)
        dist = hw_distance_batch_cuda(wb, wl, lib, llib)
        mono_w, lens_w, _ = k3_plain.filter_monomers_device(dist, lib, llib, 10)
        m = int((dist <= 10).sum(dim=1).clamp(min=1).max())
        same_forward((wb, wl, mono_w[:, :m].contiguous(), lens_w[:, :m].contiguous()),
                     f"golden windows x the library under --ed_thr 10 (rank 3, M = {m})")
        cfg = pipeline.PipelineConfig(ed_thr=10)
        lib_dp = add_reverse_complement(library)
        want = pipeline.decompose_reads([gold], lib_dp, cfg, "cuda")
        got = pipeline.decompose_reads([gold], lib_dp, cfg, "cuda",
                                       forward_fn=make_sharded_forward([dev0] * 3))
        if [[(b.monomer, b.start, b.end, b.identity) for b in bl] for _, bl in got] != \
                [[(b.monomer, b.start, b.end, b.identity) for b in bl] for _, bl in want]:
            raise AssertionError("decompose_reads --ed_thr 10 x library, sharded x 3: "
                                 "blocks differ")
        print(f"decompose_reads, golden x the library --ed_thr 10 with K1 sharded x 3: "
              f"{len(got[0][1])} blocks equal to the unsharded run's")

        # K2: the golden blocks (raw oracle) x DXZ1, pairwise and packed
        with open(os.path.join(DATA, "raw_decomposition_oracle.tsv")) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        starts = np.array([int(r[2]) for r in rows], dtype=np.int64)
        blens = np.array([int(r[3]) - int(r[2]) + 1 for r in rows], dtype=np.int32)
        fin = add_rc_interleaved(load_fasta(dxz1, upper=True))
        st = state_from_numpy(*numpy_state([], fin), dev)
        read_dev = torch.from_numpy(codes).to(dev)
        pargs = (read_dev, starts, blens, st.t_raw, st.tl_raw, st.t_homo, st.tl_homo)
        kw = dict(n_pad=len(starts) + 5, Lq=int(blens.max()))
        want = nw_identity_packed_both(*pargs, **kw)
        got = drive("sharded packed call x 3",
                    lambda: make_sharded_packed([dev0] * 3)(*pargs, **kw))
        if got["nw_identity_cross"] < 6:  # both variants on each of 3 shards
            raise AssertionError(f"sharded packed call x 3: launches {got}")
        smoke.same("nw_identity_cross", "packed call sharded x 3, golden blocks",
                   make_sharded_packed([dev0] * 3)(*pargs, **kw), want)
        idx = {r.name: i for i, r in enumerate(fin)}
        q, ql = pad_codes([codes[s : s + n] for s, n in zip(starts, blens)])
        t, tl = pad_codes([encode(fin[idx[r[1]]].seq) for r in rows])
        iargs = [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)]
        want = nw_identity_batch_cuda(*iargs)
        got = drive("sharded identity x 3", lambda: make_sharded_identity([dev0] * 3)(*iargs))
        if got["nw_identity"] != 3:
            raise AssertionError(f"sharded identity x 3: launches {got}")
        for k, (g, w) in enumerate(zip(make_sharded_identity([dev0] * 3)(*iargs), want)):
            smoke.same("nw_identity", f"identity sharded x 3, golden pairs, output {k}", g, w)
        print(f"K2 sharded x 3: the packed call on {len(starts)} golden blocks (+5 padding) x "
              f"{len(fin)} monomers x 2 variants and the pairwise entry on the {len(rows)} "
              "(block, best monomer) pairs bit-equal to one call")

        # the alignment API's row split: [cuda:0] x 3 against one device
        cases = fixtures("align_cases.json", "align_cases_b.json")
        rng = np.random.default_rng(16)
        alpha = np.array(list("ACGT"))
        qs19, ts19 = [], []
        for _ in range(19):
            n = int(rng.integers(50, 500))
            a = rng.integers(0, 4, n)
            b = a.copy()
            for i in sorted(rng.choice(n, int(rng.integers(0, 12)), replace=False).tolist(),
                            reverse=True):
                b[i] = (b[i] + 1 + rng.integers(3)) % 4
            qs19.append("".join(alpha[a]))
            ts19.append("".join(alpha[b]))
        runs = [(f"{mode} {task} fixtures", [c["q"] for c in cases if c["mode"] == mode],
                 [c["t"] for c in cases if c["mode"] == mode], mode, task, -1)
                for mode in ("SHW", "HW") for task in ("path", "locations", "distance")]
        runs += [(f"19 pairs {mode} {task} k=40", qs19, ts19, mode, task, 40)
                 for mode, task in (("NW", "path"), ("SHW", "locations"), ("HW", "locations"))]
        saved = al.ALIGN_DATA_PARALLEL, al.ROW_DEVICES
        try:
            for what, qs, ts, mode, task, k in runs:
                al.ALIGN_DATA_PARALLEL, al.ROW_DEVICES = "off", None
                single = al.align_batch(qs, ts, mode=mode, task=task, k=k, device="cuda")
                al.ALIGN_DATA_PARALLEL, al.ROW_DEVICES = "auto", [dev0] * 3
                res = {}
                got = drive(f"align rows x 3, {what}", lambda: res.update(
                    out=al.align_batch(qs, ts, mode=mode, task=task, k=k, device="cuda")))
                if not sum(got[x] for x in banded_kernels):
                    raise AssertionError(f"align rows x 3, {what}: no K4-K6 launch: {got}")
                if res["out"] != single:
                    raise AssertionError(f"align rows x 3, {what}: differs from one device")
        finally:
            al.ALIGN_DATA_PARALLEL, al.ROW_DEVICES = saved
        print(f"_rows_sharded at [cuda:0] x 3: {len(runs)} align_batch runs (SHW / HW fixtures "
              "x path, locations, distance; 19 seeded pairs NW path, SHW and HW locations at "
              "k = 40) equal to SDTPU_ALIGN_DP=off, K4-K6 launched in each")

        # the CLI: --data-parallel, two hosts, a torch.distributed group
        one = os.path.join(d, "one")
        cli_ok([read_fa, dxz1, "-o", one, "--second-best"])
        got = drive("golden CLI --data-parallel --second-best",
                    lambda: cli_ok([read_fa, dxz1, "-o", os.path.join(d, "dp"),
                                    "--data-parallel", "--second-best"]))
        if got["chain_dp_lanes"] <= 0 or got["nw_identity_cross"] <= 0:
            raise AssertionError(f"--data-parallel: kernels of the path not launched: {got}")
        same_as_golden(os.path.join(d, "dp"), "--data-parallel")
        same_files(os.path.join(d, "dp"), one, "--data-parallel against the one-GPU run")
        print("CLI --data-parallel --second-best (every visible GPU: "
              f"{torch.cuda.device_count()}): raw and final TSVs equal to the golden TSVs, alt "
              "to the one-GPU run's")
        # the DP stream keeps its batches in flight through the sharded forward
        asm = assembly_fa()
        cli_ok([asm, dxz1, "-o", os.path.join(d, "asm_one"), "--second-best"])
        one_depth = inflight_depth()
        cli_ok([asm, dxz1, "-o", os.path.join(d, "asm_dp"), "--second-best", "--data-parallel"])
        dp_depth = inflight_depth()
        same_files(os.path.join(d, "asm_dp"), os.path.join(d, "asm_one"),
                   "1.6 Mbp --data-parallel against the one-GPU run")
        if dp_depth != one_depth or "at most 4 in flight" not in dp_depth:
            raise AssertionError(f"--data-parallel: {dp_depth}; one GPU: {one_depth}")
        print(f"1.6 Mbp --data-parallel --second-best: TSVs equal to the one-GPU run's; "
              f"{dp_depth} (one GPU: {one_depth})")
        four = os.path.join(d, "four.fa")
        cut = len(gold.seq) // 4
        write_fasta(four, [Record(f"{gold.name}_{i}", gold.seq[i * cut : (i + 1) * cut])
                           for i in range(4)])
        base = [four, dxz1, "--second-best", "-o"]
        wall_one = cli_procs([base + [os.path.join(d, "four_one")]])
        hosts = os.path.join(d, "four_hosts")
        wall_hosts = cli_procs([base + [hosts, "--num-hosts", "2", "--host-id", str(h)]
                                for h in (1, 0)])
        same_files(hosts, os.path.join(d, "four_one"), "--num-hosts 2 (two processes)")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        group = os.path.join(d, "four_group")
        wall_group = cli_procs([base + [group, "--coordinator", f"localhost:{port}",
                                        "--num-processes", "2", "--host-id", str(h)]
                                for h in (0, 1)])
        same_files(group, os.path.join(d, "four_one"), "--coordinator (two processes)")
        if not os.path.exists(os.path.join(group, "final_decomposition_raw.shard00001.tsv")):
            raise AssertionError("--coordinator: no fragment of host 1")
        print(f"the golden read in 4 pieces ({n_rows(hosts)} rows), one card: one process "
              f"{wall_one[0]:.2f} s; --num-hosts 2: host 1 {wall_hosts[0]:.2f} s, host 0 "
              f"{wall_hosts[1]:.2f} s; --coordinator localhost:{port} --num-processes 2: rank 0 "
              f"{wall_group[0]:.2f} s, rank 1 {wall_group[1]:.2f} s (process walls from a "
              "common start, start-up included); three merged TSVs equal to the one-process "
              "run's each time")

        # the reliability trainer: the card against the CPU
        rng = np.random.default_rng(0)
        feats, labels = [], []
        for _ in range(400):  # the set of test_reliability_trainer_roundtrip, as main reads it
            idnt, diff = rng.uniform(50, 100), rng.uniform(0, 20)
            shown, second = float(f"{idnt:.2f}"), float(f"{idnt - diff:.2f}")
            feats.append([shown, shown - second])
            labels.append(1.0 if (idnt + diff) > 95 else 0.0)
        feats, labels = np.asarray(feats), np.asarray(labels)
        secs = {}

        def train(device, what):
            t0 = time.perf_counter()
            coef = rel.train_logreg(feats, labels, device=device)
            secs[what] = time.perf_counter() - t0
            return coef

        # twice on the card: the first call also loads PyTorch's kernels
        coef_gpu, coef_gpu2 = train("cuda", "card, first"), train("cuda", "card, again")
        coef_cpu = train("cpu", "CPU")
        err = float(max(np.abs(coef_gpu - coef_cpu).max(), np.abs(coef_gpu2 - coef_cpu).max()))
        tol = 1e-3 * max(1.0, float(np.abs(coef_cpu).max()))
        same = np.array_equal(rel.classify(feats[:, 0], feats[:, 0] - feats[:, 1], coef_gpu),
                              rel.classify(feats[:, 0], feats[:, 0] - feats[:, 1], coef_cpu))
        print(f"reliability trainer, 400 rows x 2,000 Adam steps: card {coef_gpu.tolist()}, CPU "
              f"{coef_cpu.tolist()}; max |diff| {err:.3g} (tolerance {tol:.3g}); classify equal "
              f"on every row: {same}; seconds: "
              f"{', '.join(f'{k} {v:.2f}' for k, v in secs.items())}")
        if err > tol or not same:
            raise AssertionError("the trainer on the card disagrees with the trainer on the CPU")

    def k1_bound(wb_t, mono_t, lens_t, state_bytes, variant="base", blocks_out=0):
        """K1's bound at these inputs: windows, monomers, lengths and column
        0 read once; end and spend written once (noemit: one position);
        `blocks_out` bytes of walk records; OPS_PER_CELL["k1"] int32 ops per
        cell for every window at every position."""
        B, W = wb_t.shape
        M, L = mono_t.shape[-2], mono_t.shape[-1]
        lens_sum = int(lens_t.clamp(0, L).sum()) * (B if lens_t.dim() == 1 else 1)
        emitted = 1 if variant == "noemit" else W
        nbytes = (B * W + mono_t.numel() + 4 * lens_t.numel() + B * M * L * state_bytes
                  + 2 * B * emitted * M * state_bytes + blocks_out)
        return bound(nbytes, (W - 1) * lens_sum * OPS_PER_CELL["k1"])

    def probe_checks():
        """P against its plain version on seeded random int16 data and on
        the edge values (the lane wrap, -2^15 and 2^15 - 1), and the probe
        of a fresh process says the int16 state may run."""
        for seed in range(4):
            v = torch.from_numpy(np.random.default_rng(seed).integers(
                -(1 << 15), 1 << 15, (8, 256), dtype=np.int16)).to(dev)
            smoke.same("int16_probe", f"P seed {seed}", int16_probe_cuda(v), int16_probe_plain(v))
        edge = torch.zeros((8, 256), dtype=torch.int16)
        edge[:, -1], edge[:, 0], edge[1, 5], edge[2, 7] = 32767, -32768, -32768, 32767
        edge = edge.to(dev)
        smoke.same("int16_probe", "P edge values", int16_probe_cuda(edge), int16_probe_plain(edge))
        k1._INT16_PROBE.clear()
        if int16_state_supported("cuda") is not True:
            raise AssertionError("int16_state_supported('cuda') is not True")
        k, got = timed(lambda: int16_probe_cuda(edge), 20)
        p, want = timed(lambda: int16_probe_plain(edge), 20)
        smoke.same("int16_probe", "P timed", got, want)
        timing["int16_probe"] = (statistics.median(k), statistics.median(p))
        bounds["int16_probe"] = bound(2 * edge.numel() * 2, OPS_PER_CELL["scan"] * edge.numel())
        print(f"P [8, 256] int16: kernel {spread(k)}; plain {spread(p)}; "
              "int16_state_supported('cuda') is True")

    def int16_shapes():
        """The timed shapes: the golden windows x DXZ1 (M = 24), x the
        264-monomer library (the cluster body), x its first 200 rows (int16:
        the lanes body, int32: the cluster body), x the DXZ1 dimers (L = 360:
        the lanes body's long rows), x the 150 dimer variants (the cluster
        body's), x the DXZ1 trimers (L = 528: the tiled body), x the 150
        trimer variants (the tiled cluster body), x the DXZ1 HOR unit (L =
        2,056: the tiled body)."""
        reads = load_fasta(read_fa)
        codes = encode(reads[0].seq)
        wins = [codes[o : o + n] for o, n in make_windows(len(codes), 5000, 500)]
        wb, wl = k1_plain.build_window_batch(wins, 5500)
        _, (m24, l24) = mono_set(load_fasta(dxz1))
        _, (mlib, llib) = mono_set(library)
        out = [("golden x DXZ1 M=24", wb, wl, m24, l24),
               ("golden x library M=264", wb, wl, mlib, llib),
               ("golden x library[:200] M=200", wb, wl, mlib[:200], llib[:200])]
        for what in ("dimers", "dimers variants", "trimers", "trimers variants", "hor unit"):
            _, (mono, lens) = mono_set(joined[what][0])
            out.append((f"golden x DXZ1 {what} M={mono.shape[0]} L={mono.shape[1]}", wb, wl,
                        mono, lens))
        return out

    def k1_int16_run():
        k1_checks(int16=True)
        shapes = int16_shapes()
        cap = 5500 // 8

        def path():
            k1._INT16_PROBE.clear()  # as in a fresh process: the first int16 call probes
            for _, wb, wl, mono, lens in shapes:
                args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
                chain_dp_forward_cuda(*args, max_blocks=cap, state_dtype="int16")

        got = drive("int16 K1 path: golden windows x DXZ1, x library, x library[:200], "
                    "x DXZ1 dimers, trimers and their variants, x the DXZ1 HOR unit, "
                    "state_dtype='int16'", path)
        need = ("int16_probe", "chain_dp_lanes_int16", "chain_dp_tiled_int16",
                "chain_dp_cluster_tiled_int16", "chain_dp_cluster_int16",
                "chain_dp_lanes_long_int16", "chain_dp_cluster_long_int16", "block_walk")
        bad = [k for k in need if got[k] <= 0]
        if bad:
            raise AssertionError(f"int16 K1 path: kernels not launched: {bad}")
        launches.update({k: got[k] for k in need[:-1]})
        for what, wb, wl, mono, lens in shapes:
            args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
            M, L = mono.shape
            name = k1_name(k1_body(M, L, 2), L, 2)
            # the first shape of a body is its row of the kernels line, and only
            # a row's shape runs the plain twin (the time limit)
            keep = name not in timing and not what.startswith("golden x library[:200]")
            b32, c32, (_, e32, s32) = chain_dp_forward_cuda(*args, max_blocks=cap, return_debug=True)
            b16, c16, (_, e16, s16) = chain_dp_forward_cuda(*args, max_blocks=cap, return_debug=True,
                                                            state_dtype="int16")
            real = torch.from_numpy(lens > 0).to(dev)[None, None, :]
            for nm, g, w in (("blocks", b16, b32), ("counts", c16, c32),
                             ("end (real rows)", torch.where(real, e16, e32), e32),
                             ("spend (real rows)", torch.where(real, s16, s32), s32)):
                smoke.same(name, f"{what}: int16 {nm} vs the int32 kernel", g, w)
            del e32, s32, e16, s16
            k32, _ = timed(lambda: chain_dp_forward_cuda(*args, max_blocks=cap), 5)
            k16, got16 = timed(lambda: chain_dp_forward_cuda(*args, max_blocks=cap,
                                                             state_dtype="int16"), 5)
            blocks_out = args[0].shape[0] * (cap * 16 + 4)
            bd16 = k1_bound(args[0], args[2], args[3], 2, blocks_out=blocks_out)
            bd32 = k1_bound(args[0], args[2], args[3], 4, blocks_out=blocks_out)
            line = (f"K1 + walk, {what} ({len(wb)} windows x 5500, L={L}; int16 body "
                    f"{k1_body(M, L, 2)}, int32 body {k1_body(M, L, 4)}): int32 kernel "
                    f"{spread(k32)} (bound {bd32[0]:.3f} ms, {bd32[1]}); int16 kernel "
                    f"{spread(k16)} (bound {bd16[0]:.3f} ms, {bd16[1]})")
            if keep:
                p16, want16 = timed(lambda: k1_plain.chain_dp_forward(*args, max_blocks=cap,
                                                                      state_dtype="int16"), 0)
                smoke.same(name, f"{what}: int16 blocks vs the int16 twin", got16[0], want16[0])
                smoke.same(name, f"{what}: int16 counts vs the int16 twin", got16[1], want16[1])
                timing[name] = (statistics.median(k16), statistics.median(p16))
                bounds[name] = bd16
                line += f"; int16 plain {spread(p16)}"
            chunked = {"tiled": "chunked", "cluster_tiled": "large"}.get(k1_body(M, L, 2))
            if keep and chunked:  # the chunked body at the same shape, for comparison only
                cname = k1_name(chunked, L, 2)
                kc, gotc = timed(lambda: chain_dp_forward_cuda(
                    *args, max_blocks=cap, state_dtype="int16", force_body=chunked), 3)
                smoke.same(cname, f"{what}: int16 blocks vs the int16 twin", gotc[0], want16[0])
                smoke.same(cname, f"{what}: int16 counts vs the int16 twin", gotc[1], want16[1])
                line += f"; the {chunked} body in int16 (not its row) {spread(kc)}"
            print(line)

    def ablate_run():
        from stringdecomposer_tpu_torch.scripts import ablate_chain as ab

        err = ab.check(list(VARIANTS), "cuda")
        for v, e in err.items():
            for large in (False, True):
                name = f"ablate_{'large_' if large else ''}{v}"
                smoke.max_err[name] = max(smoke.max_err[name], e)
        print(f"ablation: every variant bit-equal to its plain version on both routes at "
              f"B=5 x W=300, M=40 (max abs errors {err})")
        res = {}
        # the bench's shapes at an eighth of their positions, for the time
        # limit; the bench alone runs them whole
        shapes = tuple((n, B, W // 8, M, large) for n, B, W, M, large in ab.SHAPES)
        got = drive("ablation bench (python -m stringdecomposer_tpu_torch.scripts.ablate_chain, "
                    "W / 8)", lambda: res.update(ab.bench(list(VARIANTS), reps=3, shapes=shapes)))
        bad = [k for k in ABLATE if got[k] <= 0]
        if bad:
            raise AssertionError(f"ablation bench: kernels not launched: {bad}")
        launches.update({k: got[k] for k in ABLATE})
        for shape, B, W, M, large in shapes:
            inputs = ab.make_inputs(B, W, M, 0, dev)
            for v in VARIANTS:
                name = f"ablate_{'large_' if large else ''}{v}"
                p, want = timed(lambda: k1_plain.chain_dp_ablate(*inputs, v), 0)
                out = chain_dp_ablate_cuda(*inputs[:3], inputs[3].clone(), v, large)
                smoke.same(name, f"ablation {v}, {shape} end", out[0], want[0])
                smoke.same(name, f"ablation {v}, {shape} spend", out[1], want[1])
                del out, want
                timing[name] = (statistics.median(res[(shape, v)]), p[0])
                bounds[name] = k1_bound(inputs[0], inputs[1], inputs[2], 4, variant=v)
                print(f"ablation {v}, {shape}: kernel {spread(res[(shape, v)])}, plain "
                      f"{p[0]:.3f} ms (1 run), bound {bounds[name][0]:.3f} ms ({bounds[name][1]}); "
                      "outputs bit-equal")

    def kernel_times():
        reads = load_fasta(os.path.join(DATA, "read.fa"))
        monos, (mono, lens) = mono_set(load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa")))
        codes = encode(reads[0].seq)
        wins = [codes[o : o + n] for o, n in make_windows(len(codes), 5000, 500)]
        wb, wl = k1_plain.build_window_batch(wins, 5500)
        args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
        cap = 5500 // 8
        blocks_out = len(wins) * (cap * 16 + 4)
        k, got = timed(lambda: chain_dp_forward_cuda(*args, max_blocks=cap), 10)
        p, want = timed(lambda: k1_plain.chain_dp_forward(*args, max_blocks=cap), 0)
        smoke.same("chain_dp_lanes", "golden shape blocks", got[0], want[0])
        smoke.same("chain_dp_lanes", "golden shape counts", got[1], want[1])
        timing["chain_dp_lanes"] = (statistics.median(k), statistics.median(p))
        bd = bounds["chain_dp_lanes"] = k1_bound(args[0], args[2], args[3], 4, blocks_out=blocks_out)
        print(f"K1 lanes body + walk, {len(wins)} windows x 5500, M={mono.shape[0]}, "
              f"L={mono.shape[1]}: kernel {spread(k)}; plain {spread(p)}; bound {bd[0]:.3f} ms "
              f"({bd[1]}), {100 * bd[0] / statistics.median(k):.2f} % of it")
        # several rows a warp: the library's first 64 and 128 rows (L = 192),
        # held to and timed beside the cluster body at its plan's size on
        # the same inputs (sets the shared route takes: measured, not routed)
        _, (mlib, llib) = mono_set(library)
        for M in (64, 128):
            a = [torch.from_numpy(x).to(dev) for x in (wb, wl, mlib[:M], llib[:M])]
            if k1_body(M, mlib.shape[1]) != "lanes":
                raise AssertionError(f"M={M}: body {k1_body(M, mlib.shape[1])}")
            k, got = timed(lambda: chain_dp_forward_cuda(*a, max_blocks=cap), 5)
            kc, want = timed(lambda: chain_dp_large_cuda(*a, max_blocks=cap), 5)
            smoke.same("chain_dp_lanes", f"M={M} blocks vs the cluster body", got[0], want[0])
            smoke.same("chain_dp_lanes", f"M={M} counts vs the cluster body", got[1], want[1])
            bd = k1_bound(a[0], a[2], a[3], 4, blocks_out=blocks_out)
            print(f"K1 lanes body + walk, {len(wins)} windows x 5500, M={M}, L={mlib.shape[1]}: "
                  f"kernel {spread(k)}; bound {bd[0]:.3f} ms ({bd[1]}), "
                  f"{100 * bd[0] / statistics.median(k):.2f} % of it; the cluster body at cs = "
                  f"{plan_at(M, mlib.shape[1], 4, len(wins))[0]}: {spread(kc)}")
        plain_runs = {}  # what -> (plain ms, plain outputs): one plain run a shape

        def k1_time(name, what, records, fn=chain_dp_forward_cuda, reps=5, plain=True, body=None,
                    windows=None):
            """K1 + walk at the golden windows (or `windows`) x `records` with
            RC, timed, on the body the rule picks or on `body`; with `plain`,
            held to the plain twin (run once a shape) and kept as `name`'s row
            of the kernels line, else timed only (and held to the twin where
            an earlier call ran it on the shape: a comparison line)."""
            wb_, wl_ = windows or (wb, wl)
            _, (mono_np, lens_np) = mono_set(records)
            a = [torch.from_numpy(x).to(dev) for x in (wb_, wl_, mono_np, lens_np)]
            M, L = mono_np.shape
            kind = body or k1_body(M, L)
            if k1_name(kind, L, 4) != name:
                raise AssertionError(f"{what} (M={M}, L={L}): body {kind}, not {name}")
            extra = {"force_body": body} if body else {}
            k, got = timed(lambda: fn(*a, max_blocks=cap, **extra), reps)
            bd = k1_bound(a[0], a[2], a[3], 4, blocks_out=len(wb_) * (cap * 16 + 4))
            line = f"K1 {name} + walk, {len(wb_)} windows x 5500, {what} (M={M}, L={L})"
            if kind in ("cluster", "cluster_tiled"):
                plan = plan_at(M, L, 4, len(wb_))
                line += (f" (cs = {plan[0]}, R = {plan[1]}, {plan[2]}, {plan[3]} threads; "
                         f"{k1.cluster_occupancy(M, L, 4, plan[0], len(wb_))} clusters at once)")
            if kind in ("tiled", "cluster_tiled"):
                G, C, _ = k1.tiled_layout(M if kind == "tiled" else plan[1], L)
                line += f" (G = {G} warps a row, C = {C})"
            line += f": kernel {spread(k)}"
            if plain and what not in plain_runs:
                plain_runs[what] = timed(lambda: k1_plain.chain_dp_forward(*a, max_blocks=cap), 0)
            if what in plain_runs:
                p, want = plain_runs[what]
                smoke.same(name, f"golden windows x {what} blocks", got[0], want[0])
                smoke.same(name, f"golden windows x {what} counts", got[1], want[1])
            if plain:
                timing[name] = (statistics.median(k), statistics.median(p))
                bounds[name] = bd
                line += f"; plain {spread(p)}"
            else:
                line += " (comparison, not the kernels line's row)"
            print(f"{line}; bound {bd[0]:.3f} ms ({bd[1]}), "
                  f"{100 * bd[0] / statistics.median(k):.2f} % of it")

        # the lanes body's long rows (L = 360 and 512) and the tiled body past
        # them (L = 528, and the HOR unit at 2,056), beside the chunked body
        # on the trimers: the golden windows x the DXZ1 dimers, the trimers
        # cut to 512 bp, the trimers and the HOR unit
        k1_time("chain_dp_lanes_long", "DXZ1 dimers", dimers)
        k1_time("chain_dp_lanes_long", "DXZ1 trimers cut to 512 bp",
                [Record(r.name, r.seq[:512]) for r in trimers], plain=False)
        k1_time("chain_dp_tiled", "DXZ1 trimers", trimers)
        k1_time("chain_dp", "DXZ1 trimers", trimers, plain=False, body="chunked")
        k1_time("chain_dp_tiled", "DXZ1 HOR unit", hor, plain=False)
        _, _, (_, end, spend) = chain_dp_forward_cuda(*args, max_blocks=cap, return_debug=True)
        k, got = timed(lambda: block_walk_cuda(end, spend, args[1], cap), 10)
        p, want = timed(lambda: k1_plain.block_walk(end, spend, args[1], cap), 0)
        smoke.same("block_walk", "golden shape blocks", got[0], want[0])
        smoke.same("block_walk", "golden shape counts", got[1], want[1])
        timing["block_walk"] = (statistics.median(k), statistics.median(p))
        # the columns the walk reads: the last one, then the one before each
        # block start (M end scores each), plus an end and a start per block
        cols = len(wins) + int(got[1].sum())
        M = end.shape[2]
        bounds["block_walk"] = bound(4 * (cols * M + 2 * int(got[1].sum()) + len(wins))
                                     + got[0].numel() * 4 + 4 * len(wins),
                                     OPS_PER_CELL["scan"] * cols * M)
        print(f"walk alone on the same end/spend: kernel {spread(k)}; plain {spread(p)}; bound "
              f"{bounds['block_walk'][0]:.6f} ms ({bounds['block_walk'][1]})")
        # K3 on each route: the thread route at the golden windows x DXZ1,
        # x the library (its kernels-line row) and 64 windows of the 1.6 Mbp
        # assembly x the library (run (iii)'s batch); the warp route at the
        # golden windows x the DXZ1 trimers (L = 528); the wide route at the
        # ~17 kbp unit's run
        asm_codes = encode(load_fasta(assembly_fa())[0].seq)
        wb64, wl64 = k1_plain.build_window_batch(
            [asm_codes[o : o + n] for o, n in make_windows(len(asm_codes), 5000, 500)][:64], 5500)
        wreads, wmonos = wide_case()
        wcodes = encode(wreads[0].seq)
        wbw, wlw = k1_plain.build_window_batch(
            [wcodes[o : o + n] for o, n in make_windows(len(wcodes), 5000, 500)], 5500)
        for name, what, (wb_, wl_), records, reps, keep in (
                ("hw_filter", "golden windows x DXZ1", (wb, wl), load_fasta(dxz1), 10, False),
                ("hw_filter", "golden windows x library", (wb, wl), library, 10, True),
                ("hw_filter", "64 windows x library", (wb64, wl64), library, 10, False),
                ("hw_filter_warp", "golden windows x DXZ1 trimers", (wb, wl), trimers, 5, True),
                ("hw_filter_wide", "unit x2 windows x the unit", (wbw, wlw), wmonos, 3, True)):
            if name == "hw_filter_wide":
                mono, lens = pad_monomers(records)
            else:
                _, (mono, lens) = mono_set(records)
            args = [torch.from_numpy(a).to(dev) for a in (wb_, wl_, mono, lens)]
            k, got = timed(lambda: hw_distance_batch_cuda(*args), reps)
            p, want = timed(lambda: k3_plain.hw_distance_batch(*args), 0)
            smoke.same(name, what, got, want)
            W, (M, L) = args[0].shape[1], mono.shape
            wl_sum = int(args[1].clamp(0, W).sum())
            ml = args[3].clamp(0, L)
            nbytes = args[0].numel() + args[2].numel() + 4 * got.numel()
            words = wl_sum * int(((ml + 31) // 32).sum())
            bd = bound(nbytes, OPS_PER_CELL["k3_word"] * words)
            cell_bd = bound(nbytes, OPS_PER_CELL["hw"] * wl_sum * int(ml.sum()))
            if keep:
                timing[name] = (statistics.median(k), statistics.median(p))
                bounds[name] = bd
            print(f"K3 {name}, {what} (B={args[0].shape[0]}, W={W}, M={M}, L={L}; plan "
                  f"{k3.plan(args[0].shape[0], M, L, W, 0)}): kernel {spread(k)}; plain "
                  f"{spread(p)}; bound {bd[0]:.4f} ms ({bd[1]}, Myers words at "
                  f"{OPS_PER_CELL['k3_word']} ops), {100 * bd[0] / statistics.median(k):.2f} % "
                  f"of it; the cell DP's bound {cell_bd[0]:.4f} ms")
        # K1's cluster body at the golden windows x the library
        _, (mono, lens) = mono_set(library)
        args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
        plan = plan_at(*mono.shape, 4, len(wins))
        if k1_body(*mono.shape) != "cluster":
            raise AssertionError(f"library: body {k1_body(*mono.shape)}")
        k, got = timed(lambda: chain_dp_forward_cuda(*args, max_blocks=cap), 10)
        p, want = timed(lambda: k1_plain.chain_dp_forward(*args, max_blocks=cap), 0)
        smoke.same("chain_dp_cluster", "golden windows x library blocks", got[0], want[0])
        smoke.same("chain_dp_cluster", "golden windows x library counts", got[1], want[1])
        timing["chain_dp_cluster"] = (statistics.median(k), statistics.median(p))
        bd = bounds["chain_dp_cluster"] = k1_bound(args[0], args[2], args[3], 4,
                                                  blocks_out=blocks_out)
        print(f"K1 cluster body + walk, {len(wins)} windows x 5500, M={mono.shape[0]}, "
              f"L={mono.shape[1]} (cs = {plan[0]}, R = {plan[1]}, {plan[2]}, {plan[3]} threads, "
              f"{plan[4]} bytes of shared memory; {k1.cluster_occupancy(*mono.shape, 4, plan[0], 19)} "
              f"clusters at once): kernel {spread(k)}; plain {spread(p)}; bound {bd[0]:.3f} ms "
              f"({bd[1]}), {100 * bd[0] / statistics.median(k):.2f} % of it")
        # the cluster body's long rows and the tiled cluster body past them,
        # beside the chunked large route: the golden windows x the 150 dimer
        # variants (L = 360), x the 150 trimer variants cut to 512 bp and x
        # the trimer variants (L = 528); the ~17 kbp unit's windows x the unit
        k1_time("chain_dp_cluster_long", "150 dimer variants", variants)
        k1_time("chain_dp_cluster_long", "150 trimer variants cut to 512 bp",
                [Record(r.name, r.seq[:512]) for r in trimer_variants], plain=False)
        k1_time("chain_dp_cluster_tiled", "150 trimer variants", trimer_variants)
        k1_time("chain_dp_large", "150 trimer variants", trimer_variants, reps=3, plain=False,
                body="large")
        k1_time("chain_dp_cluster_tiled", "the ~17 kbp unit", wmonos[:1], plain=False,
                windows=(wbw, wlw))
        print("times: every timed kernel output bit-equal to its plain version's")

    banded_kernels = ("banded_final_column", "banded_myers", "semi_ends")

    def rand_pairs(P, Lq, Lt, seed, alpha=4, t_neg=False):
        """Random codes on the card with ragged lengths: pair 0 at full
        width, pair 1 with an empty query, pair 2 with an empty target."""
        r = np.random.default_rng(seed)
        q = r.integers(0, alpha, (P, Lq)).astype(np.int32)
        t = r.integers(-1 if t_neg else 0, alpha, (P, Lt)).astype(np.int32)
        ql = r.integers(0, Lq + 1, P).astype(np.int32)
        tl = r.integers(0, Lt + 1, P).astype(np.int32)
        ql[0], tl[0] = Lq, Lt
        if P > 2:
            ql[1], tl[2] = 0, 0
        return [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)]

    shapes = ((7, 300, 333), (3, 1000, 900), (5, 17, 40))

    def mask_codes(P, Lq, r):
        """Equality bitmasks over 7 symbols, 2 bits a query row, on the card."""
        return torch.from_numpy(((1 << r.integers(0, 7, (P, Lq))) | (1 << r.integers(0, 7, (P, Lq))))
                                .astype(np.int32)).to(dev)

    def small_stages(fn_name, run):
        """run() with ops/banded's `fn_name` (the wide route's shape)
        patched to 32 stages a band, so that a small pair crosses bands of
        stages (K4: 1,024 rows a band, its bands at once on a cluster of up
        to 8 blocks; K5: 8,192 offset rows, its top links allocated)."""
        keep = getattr(banded, fn_name)
        small = {"banded_wide_shape": lambda Lq, Lt, k: keep(Lq, Lt, k, stages=32),
                 "myers_wide_stages": lambda Lq, Lt, k: (32, True)}[fn_name]
        setattr(banded, fn_name, small)
        try:
            return run()
        finally:
            setattr(banded, fn_name, keep)

    def k4_checks():
        """The warp route at k in {0, 1, 15, 16, 31, 32, 63, 64, 255} (R = 1..16),
        plain codes and equality bitmasks, bit-equal to the plain twin and to
        the wide route (the pipeline of stages) forced on the same inputs;
        k = 256, 512, 1,024, 8,192 and 40,000 on the wide route (auto),
        plain and mask mode, held to the twin; the wide route in bands of 32
        stages (1,024 rows; a pair's bands at once on a cluster of 1 +
        ceil(2k / 1,024) blocks, at most 8, each block every cs-th band
        past that) and a 20,000 x 9,000 pair in five bands of 128 stages
        (4,096 rows), mask mode, held to the twin."""
        r = np.random.default_rng(1)
        for k in (0, 1, 15, 16, 31, 32, 63, 64, 255):
            for P, Lq, Lt in shapes + ((40, 600, 500),):
                for mask in (False, True):
                    a = rand_pairs(P, Lq, Lt, seed=k * P + mask, alpha=7 if mask else 4,
                                   t_neg=not mask)
                    if mask:
                        a[0] = mask_codes(P, Lq, r)
                    what = f"K4 k={k} P={P} Lq={Lq} Lt={Lt}{' mask mode' if mask else ''}"
                    got = banded_final_column_cuda(*a, k=k, use_mask=mask, route="warp")
                    smoke.same("banded_final_column", f"{what} (warp)", got,
                               banded.banded_final_column(*a, k=k, use_mask=mask))
                    smoke.same("banded_final_column_wide", f"{what} (wide)",
                               banded_final_column_cuda(*a, k=k, use_mask=mask, route="wide"), got)
        # the wide route (auto) where align_wide's mask-mode k-doubling takes
        # it (k = 256 .. 8,192), and past it (k = 40,000), plain and mask mode
        for k, (P, Lq, Lt) in ((256, (7, 700, 650)), (512, (5, 1300, 1200)),
                               (1024, (3, 2500, 2100)), (8192, (2, 9217, 1024)),
                               (40000, (2, 3000, 1500))):
            for mask in (False, True):
                a = rand_pairs(P, Lq, Lt, seed=5 + mask, alpha=7 if mask else 4, t_neg=not mask)
                if mask:
                    a[0] = mask_codes(P, Lq, r)
                before = (banded_final_column_cuda.launches, banded_final_column_cuda.launches_wide)
                smoke.same("banded_final_column_wide",
                           f"K4 k={k} P={P} Lq={Lq} Lt={Lt}{' mask mode' if mask else ''} (wide)",
                           banded_final_column_cuda(*a, k=k, use_mask=mask),
                           banded.banded_final_column(*a, k=k, use_mask=mask))
                after = (banded_final_column_cuda.launches, banded_final_column_cuda.launches_wide)
                if (after[0] - before[0], after[1] - before[1]) != (0, 1):
                    raise AssertionError(f"K4 k={k}: launches {before} -> {after}, not the wide "
                                         "route")
        # bands of stages: 32 stages a band (1,024 rows) on pairs of up to
        # 10,000 rows (at k = 4,000 10 bands, two a block on the cluster of
        # 8; at k = 40 and 300 a cluster of 2, at 1,200 of 4), the band's
        # bottom and top crossing the band seams; and a pair of 20,000 x
        # 9,000 at k = 8,192 (rows up to 17,192: five bands of 128 stages)
        for k, (P, Lq, Lt) in ((300, (4, 3000, 2500)), (40, (4, 2600, 2600)),
                               (1200, (3, 2500, 1800)), (4000, (2, 10000, 9500))):
            for mask in (False, True):
                a = rand_pairs(P, Lq, Lt, seed=k + mask, alpha=7 if mask else 4, t_neg=not mask)
                if mask:
                    a[0] = mask_codes(P, Lq, r)
                smoke.same("banded_final_column_wide",
                           f"K4 k={k} P={P} Lq={Lq} Lt={Lt}{' mask mode' if mask else ''} (wide, "
                           "bands of 32 stages)",
                           small_stages("banded_wide_shape", lambda: banded_final_column_cuda(
                               *a, k=k, use_mask=mask, route="wide")),
                           banded.banded_final_column(*a, k=k, use_mask=mask))
        a = rand_pairs(2, 20000, 9000, seed=20, alpha=7)
        a[0] = mask_codes(2, 20000, r)
        if banded.banded_wide_shape(20000, 9000, 8192) != (128, 4, 5):
            raise AssertionError(f"K4 20000 x 9000: {banded.banded_wide_shape(20000, 9000, 8192)}")
        smoke.same("banded_final_column_wide", "K4 k=8192 P=2 Lq=20000 Lt=9000 mask mode (wide, "
                   "five bands of 128 stages at once)",
                   banded_final_column_cuda(*a, k=8192, use_mask=True),
                   banded.banded_final_column(*a, k=8192, use_mask=True))
        print("K4: the warp route at k in {0, 1, 15, 16, 31, 32, 63, 64, 255} on ragged shapes "
              "(P = 7, 3, 5, 40; empty query and target rows), plain and mask mode, every lane "
              "bit-equal to the plain twin and to the wide route; the wide route at k = 256, 512, "
              "1024, 8192 and 40000, plain and mask mode, in bands of 32 stages at k = 40, 300, "
              "1200, 4000 (up to 10 bands on a cluster of 8 blocks), and a 20000 x 9000 pair at k "
              "= 8192 in five bands of 128 stages at once, mask mode, bit-equal to the twin")

    def wide_launches(fn):
        """The wide routes' launches (K5, K6) that fn makes."""
        before = (banded_myers_cuda.launches_wide, semi_ends_cuda.launches_wide)
        fn()
        return (banded_myers_cuda.launches_wide - before[0], semi_ends_cuda.launches_wide - before[1])

    def k5_checks():
        """The warp route bit-equal to the twin on every lane and to the wide
        route (the pipeline of stages) forced on the same inputs; past k = 1000
        the twin (a Python loop a column) takes the two smaller shapes and
        the wide route, itself held to the twin, a pair of 2k + 600 columns
        that crosses into the columns past k."""
        small = ((4, 50, 40), (40, 600, 500))
        for k in (8, 31, 256, 300, 1000, 4096, 8175, 8191):
            for P, Lq, Lt in (((7, 700, 650), (3, 1300, 1200)) + small if k <= 1000 else
                              small + ((2, 2 * k + 600, 2 * k + 600),)):
                a = rand_pairs(P, Lq, Lt, seed=k + P, t_neg=True)
                got = banded_myers_cuda(*a, k=k, route="warp")
                if Lt <= 1200:
                    smoke.same("banded_myers", f"K5 warp k={k} P={P} Lq={Lq} Lt={Lt}",
                               got, banded.banded_final_column_myers(*a, k=k))
                smoke.same("banded_myers_wide", f"K5 wide k={k} P={P} Lq={Lq} Lt={Lt}",
                           banded_myers_cuda(*a, k=k, route="wide"), got)
        a = rand_pairs(2, 45000, 120, seed=9, t_neg=True)
        n = wide_launches(lambda: smoke.same(
            "banded_myers_wide", "K5 k=20000 (the wide route)",
            banded_myers_cuda(*a, k=20000), banded.banded_final_column_myers(*a, k=20000)))
        if n != (1, 0):
            raise AssertionError(f"K5 k=20000: wide-route launches {n}, expected (1, 0)")
        # bands of stages: 32 stages a band (8,192 offset rows) on pairs whose
        # offset rows reach 9,000-13,000, and a pair of 135,000 rows at k =
        # 65,000 (132,000 offset rows: two bands of 512 stages)
        for k, (P, Lq, Lt) in ((3000, (4, 10000, 3000)), (2000, (3, 9000, 5000))):
            a = rand_pairs(P, Lq, Lt, seed=k, t_neg=True)
            smoke.same("banded_myers_wide", f"K5 k={k} P={P} Lq={Lq} Lt={Lt} (wide, bands of 32 "
                       "stages)", small_stages("myers_wide_stages", lambda: banded_myers_cuda(
                           *a, k=k, route="wide")), banded.banded_final_column_myers(*a, k=k))
        a = rand_pairs(2, 135000, 2000, seed=11, t_neg=True)
        if banded.myers_wide_stages(135000, 2000, 65000) != (512, True):
            raise AssertionError(f"K5 135000 x 2000: {banded.myers_wide_stages(135000, 2000, 65000)}")
        smoke.same("banded_myers_wide", "K5 k=65000 P=2 Lq=135000 Lt=2000 (wide, two bands of 512 "
                   "stages)", banded_myers_cuda(*a, k=65000),
                   banded.banded_final_column_myers(*a, k=65000))
        print("K5: the warp route at k in {8, 31, 256, 300, 1000, 4096, 8175, 8191} (R = 1..16; "
              "below MYERS_MIN_K the routers patch it down) on ragged shapes up to 40 pairs, every "
              "lane bit-equal to the plain twin (past k = 1000 on the two smaller shapes) and to "
              "the wide route (past k = 1000 also at 2k + 600 columns); k = 20000 on the wide "
              "route (auto), in bands of 32 stages at k = 2000 and 3000, and a 135000-row pair at "
              "k = 65000 in two bands of 512 stages, bit-equal to the twin")

    def k6_checks():
        """The warp route, one warp a pair, bit-equal to the twin and to the
        wide route (the stages' pipeline); HW segments equal to one warp or
        one block a pair, at small S across many seams and at the plans' S
        on the 4 kbp x 1 Mbp and 17 kbp x 1 Mbp runs; queries past 131,072
        rows (bands of stages) against the twin on a few columns."""
        for Lq in (1, 31, 32, 33, 700, 4096, 16384):
            for hw in (True, False):
                a = rand_pairs(5, Lq, 600, seed=Lq, t_neg=True)
                mode = "HW" if hw else "SHW"
                got = semi_ends_cuda(*a, free_target_prefix=hw, route="warp",
                                     seg_cols=0 if hw else None)
                smoke.same("semi_ends", f"K6 warp Lq={Lq} {mode}", got,
                           banded.semi_ends_myers(*a, free_target_prefix=hw))
                smoke.same("semi_ends_wide", f"K6 wide Lq={Lq} {mode}",
                           semi_ends_cuda(*a, free_target_prefix=hw, route="wide",
                                          seg_cols=0 if hw else None), got)
                if hw:
                    for S in (32, 96, 160):
                        smoke.same("semi_ends", f"K6 HW Lq={Lq} segments of {S}",
                                   semi_ends_cuda(*a, seg_cols=S), got)
                        smoke.same("semi_ends_wide", f"K6 wide HW Lq={Lq} segments of {S}",
                                   semi_ends_cuda(*a, route="wide", seg_cols=S), got)
        # past the warp route: 17,000 and 40,000 rows (one band), and 140,000
        # rows with q_lens at the 512-stage band's seam (bands of stages)
        for Lq, Lt, lens in ((17000, 600, None), (40000, 80, None),
                             (140000, 40, (131072, 131073, 140000))):
            a = rand_pairs(3, Lq, Lt, seed=3, t_neg=True)
            if lens:
                a[1] = torch.tensor(lens, dtype=torch.int32, device=dev)
            for hw in (True, False):
                n = wide_launches(lambda: smoke.same(
                    "semi_ends_wide", f"K6 Lq={Lq} x {Lt} {'HW' if hw else 'SHW'} (the wide route)",
                    semi_ends_cuda(*a, free_target_prefix=hw, seg_cols=0 if hw else None),
                    banded.semi_ends_myers(*a, free_target_prefix=hw)))
                if n != (0, 1):
                    raise AssertionError(f"K6 Lq={Lq}: wide-route launches {n}, expected (0, 1)")
        s = scale_pairs()
        codes = [torch.from_numpy(encode(x).astype(np.int32)[None, :]).to(dev)
                 for x in (s["tq"], s["big_t"])]
        full = [codes[0], torch.tensor([4096], dtype=torch.int32, device=dev), codes[1],
                torch.tensor([1 << 20], dtype=torch.int32, device=dev)]
        cut = [full[0], full[1], codes[1][:, :8192].contiguous(),
               torch.tensor([8192], dtype=torch.int32, device=dev)]
        smoke.same("semi_ends", "K6 HW 4096 x 8192 segments of 64 (128 seams) vs the twin",
                   semi_ends_cuda(*cut, seg_cols=64), banded.semi_ends_myers(*cut))
        plan = banded_cuda.segment_plan(1, 4096, 1 << 20, *banded_cuda._card_warps(0, 128))
        smoke.same("semi_ends", f"K6 HW 4096 x 1048576 at the plan's {plan[0]} segments of "
                   f"{plan[1]} vs one warp", semi_ends_cuda(*full), semi_ends_cuda(*full, seg_cols=0))
        wide_full = wide_scale_pair()
        wplan = wide_plan(wide_full)
        if wplan[0] < 2:
            raise AssertionError(f"K6 17 kbp x 1 Mbp: the wide plan {wplan} takes no segments")
        smoke.same("semi_ends_wide", f"K6 HW 17000 x 1048576 at the plan's {wplan[0]} segments of "
                   f"{wplan[1]} vs one block", semi_ends_cuda(*wide_full),
                   semi_ends_cuda(*wide_full, seg_cols=0))
        print(f"K6: the warp route at Lq in {{1, 31, 32, 33, 700, 4096, 16384}} (R = 1..16), HW and "
              "SHW, bit-equal to the plain twin and to the wide route (also in segments of 32, 96, "
              "160); HW segments of 32, 96, 160 columns equal to one warp a pair; 4096 x 8192 in "
              f"segments of 64 equal to the twin; 4 kbp x 1 Mbp HW at the plan's {plan} equal to "
              "one warp; the wide route at Lq = 17000, 40000 and 140000 (q_len 131072, 131073, "
              "140000: bands of 512 stages) bit-equal to the twin, HW and SHW; 17 kbp x 1 Mbp HW at "
              f"the wide plan's {wplan} equal to one block")

    def wide_scale_pair():
        """align_wide's 17 kbp query against a 1 Mbp target that holds its
        20 kbp target at 524,288 (numpy.random.default_rng(4) around it),
        as [q, q_lens, t, t_lens] on the card."""
        if "wide_1m" not in cache:
            _, _, q17, t20 = wide_pairs()
            r = np.random.default_rng(4)
            bg = "".join(np.array(list("ACGT"))[r.integers(0, 4, (1 << 20) - len(t20))])
            cache["wide_1m"] = (q17, bg[: 1 << 19] + t20 + bg[1 << 19 :])
        q17, t1m = cache["wide_1m"]
        codes = [torch.from_numpy(encode(x).astype(np.int32)[None, :]).to(dev) for x in (q17, t1m)]
        lens = [torch.tensor([len(x)], dtype=torch.int32, device=dev) for x in (q17, t1m)]
        return [codes[0], lens[0], codes[1], lens[1]]

    def wide_plan(args):
        """The segments K6's wide route takes for [q, q_lens, t, t_lens] on
        this card."""
        Lq, Lt = args[0].shape[1], args[2].shape[1]
        return banded_cuda.wide_segment_plan(
            1, Lq, Lt, *banded_cuda._card_blocks(0, banded_cuda.wide_shape(Lq)[0]))

    def wide_pairs():
        """align_wide's pairs (`workloads.wide_pairs`, numpy.random.default_rng(3)),
        made once."""
        if "wide" not in cache:
            cache["wide"] = workload_wide_pairs(np.random.default_rng(3))
        return cache["wide"]

    def align_wide():
        """The alignment API through the wide routes: the NW distance of a
        40 kbp pair at 15 % divergence (k-doubling reaches k = 8,192, 513
        words: K5's wide route), and the same under an equality that
        changes nothing (mask mode, which K5 never takes: K4's warp route at
        k = 128, its wide route at k = 256..8,192), equal; HW distance of a
        17 kbp query (532 words: K6's wide route) in a 20 kbp target, equal
        to the scan route's, and in a 1 Mbp target that holds the 20 kbp one
        (the wide route in the plan's segments), equal to one block a pair
        and at most the 20 kbp target's."""
        q40, t40, q17, t20 = wide_pairs()
        wide_scale_pair()
        t1m = cache["wide_1m"][1]
        res = {}

        def runs():
            res["nw"] = al.align(q40, t40, mode="NW", device="cuda")["editDistance"]
            res["nw_mask"] = al.align(q40, t40, mode="NW", additionalEqualities=[("N", "A")],
                                      device="cuda")["editDistance"]
            res["hw"] = al.align(q17, t20, mode="HW", device="cuda")["editDistance"]
            res["hw_1m"] = al.align(q17, t1m, mode="HW", device="cuda")["editDistance"]

        got = drive("align_wide: NW distance 40 kbp (k = 8192; and in mask mode), HW distance "
                    "17 kbp x 20 kbp and x 1 Mbp", runs)
        wide = ("banded_final_column_wide", "banded_myers_wide", "semi_ends_wide")
        launches.update({k: got[k] for k in wide})
        if any(got[k] <= 0 for k in wide + ("banded_final_column",)):
            raise AssertionError(f"align_wide: a wide route or K4's warp route did not launch: {got}")
        try:
            banded.DEFAULT_BACKEND = "scan"
            hw_scan = al.align(q17, t20, mode="HW", device="cuda")["editDistance"]
            banded.DEFAULT_BACKEND = "auto"
            banded_cuda.wide_segment_plan = lambda P, Lq, Lt, sms, resident: (1, Lt)
            hw_one = al.align(q17, t1m, mode="HW", device="cuda")["editDistance"]
        finally:
            banded.DEFAULT_BACKEND = "auto"
            banded_cuda.wide_segment_plan = wide_segment_plan
        if (res["nw_mask"], res["hw"], res["hw_1m"]) != (res["nw"], hw_scan, hw_one) \
                or res["hw_1m"] > res["hw"]:
            raise AssertionError(f"align_wide: {res} against scan {hw_scan}, one block {hw_one}")
        print(f"align_wide: NW distance 40 kbp d={res['nw']} equal in mask mode (K4); HW distance "
              f"17 kbp x 20 kbp d={res['hw']} equal to the scan route's; x 1 Mbp d={res['hw_1m']} "
              f"in the wide plan's {wide_plan(wide_scale_pair())} segments, equal to one block")

    def fixtures(*names):
        out = []
        for name in names:
            with open(os.path.join(FIXTURES, name)) as f:
                out.extend(json.load(f))
        return out

    def same_result(r, c, what):
        """An align_batch result against a reference fixture."""
        if r["editDistance"] != c["ed"]:
            raise AssertionError(f"{what}: editDistance {r['editDistance']} != {c['ed']}")
        if c["ed"] < 0:
            return
        for key in ("endLocations", "startLocations", "cigar"):
            if key in c and (c[key] or key == "cigar") and r[key] != c[key]:
                raise AssertionError(f"{what}: {key} {r[key]!r} != {c[key]!r}")

    def align_fixture_runs(what, equalities=True):
        cases = fixtures("align_cases.json", "align_cases_b.json")
        for mode in ("NW", "SHW", "HW"):
            sub = [c for c in cases if c["mode"] == mode]
            res = al.align_batch([c["q"] for c in sub], [c["t"] for c in sub], mode=mode,
                                 task="path", device="cuda")
            for i, (c, r) in enumerate(zip(sub, res)):
                if c["k"] >= 0:
                    r = al.align_batch([c["q"]], [c["t"]], mode=mode, task="path", k=c["k"],
                                       device="cuda")[0]
                same_result(r, c, f"align case {mode} {i} ({what})")
        hb = fixtures("hirschberg_cases.json")
        for bound in (512, 2048):
            al.HB_MEM_BOUND = bound
            for mode in ("NW", "SHW", "HW"):
                sub = [c for c in hb if c["bound"] == bound and c["mode"] == mode]
                res = al.align_batch([c["q"] for c in sub], [c["t"] for c in sub], mode=mode,
                                     task="path", device="cuda")
                for i, (c, r) in enumerate(zip(sub, res)):
                    same_result(r, c, f"hirschberg case {bound} {mode} {i}")
        al.HB_MEM_BOUND = 1 << 20
        if not equalities:
            return
        iupac = [("N", "A"), ("N", "C"), ("N", "G"), ("N", "T"),
                 ("R", "A"), ("R", "G"), ("Y", "C"), ("Y", "T")]
        wide = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789"
        wide_pairs = [(wide[i], wide[26 + i]) for i in range(26)] + \
                     [(chr(ord("0") + i), chr(ord("A") + (i % 5))) for i in range(10)]
        for name, pairs in (("edlib_eq_cases.json", iupac), ("edlib_wide_eq_cases.json", wide_pairs)):
            for i, c in enumerate(fixtures(name)):
                r = al.align_batch([c["q"]], [c["t"]], mode=c["mode"], task="path", k=c["k"],
                                   additional_equalities=pairs[: c["npairs"]], device="cuda")[0]
                same_result(r, c, f"{name} {i}")

    def align_checks():
        def runs():
            myers_min_k, hb_bound = banded.MYERS_MIN_K, al.HB_MEM_BOUND
            try:
                align_fixture_runs("auto")
                # K5 serves the small fixtures too; equality bitmasks and the
                # lut gather never take it
                banded.MYERS_MIN_K = 8
                align_fixture_runs("auto, MYERS_MIN_K 8", equalities=False)
            finally:
                banded.MYERS_MIN_K, al.HB_MEM_BOUND = myers_min_k, hb_bound

        got = drive("align: the reference fixtures on cuda (auto)", runs)
        bad = [k for k in banded_kernels if got[k] <= 0]
        if bad:
            raise AssertionError(f"align: kernels of the path not launched: {bad}")
        print("align: 420 align cases (path, per-case k), 180 Hirschberg cases (bound 512 and "
              "2048), 60 + 36 equality cases equal to the reference edlib on cuda; the align "
              "and Hirschberg cases again with MYERS_MIN_K = 8")

    scale_inputs = {}

    def scale_pairs():
        """The pairs of scripts/bench_align.py's workloads, from one
        numpy.random.default_rng(0): 262,144 bp at 1 % divergence, then a
        4,096 bp query whose copy repeated to 1,048,576 bp is the target,
        then an 8,192 bp pair for the cut comparison."""
        if not scale_inputs:
            scale_inputs.update(align_pairs(np.random.default_rng(0)))
        return scale_inputs

    def walls(what, fn, reps=3):
        secs, res = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        print(f"{what}: wall min {min(secs):.3f} / median {statistics.median(secs):.3f} / "
              f"max {max(secs):.3f} s over {reps}", flush=True)
        return res

    def semi_runs(tq, target, route, reps, ks=(32, 64, 256)):
        """SHW and HW x distance and locations x k in ks and -1 (SHW at
        k = 32 and 64 is K4's band, k = 256 K5's, since MYERS_MIN_K = 128);
        wherever a banded run finds the pair, its result equals k = -1's,
        and where it does not, it reports none."""
        out = {}
        for mode in ("SHW", "HW"):
            for task in ("distance", "locations"):
                res = {k: walls(f"{mode} {task} {len(tq)} bp x {len(target)} bp k={k} [{route}]",
                                lambda k=k: al.align_batch([tq], [target], mode=mode, task=task,
                                                           k=k, device="cuda")[0], reps)
                       for k in ks + (-1,)}
                full = res[-1]
                for k in ks:
                    want = full if full["editDistance"] <= k else {
                        "editDistance": -1, "endLocations": [], "startLocations": None,
                        "cigar": None}
                    if res[k] != want:
                        raise AssertionError(f"{mode} {task} k={k}: {res[k]} != {want}")
                print(f"{mode} {task}: d={full['editDistance']}, {len(full['endLocations'])} "
                      f"end locations; k in {ks} agree with k=-1")
                out[(mode, task)] = res
        return out

    def align_scale():
        s = scale_pairs()
        q, t = s["q"], s["t"]

        def main_runs():
            path = walls("NW path 262,144 bp (Hirschberg, banded sweeps)",
                         lambda: al.align(q, t, mode="NW", task="path", device="cuda"))
            dist = walls("NW distance 262,144 bp k=-1 (k-doubling)",
                         lambda: al.align(q, t, mode="NW", task="distance", device="cuda"))
            cost = cigar_cost(path["cigar"], q, t)
            if not cost == path["editDistance"] == dist["editDistance"]:
                raise AssertionError(f"path cost {cost}, path d {path['editDistance']}, "
                                     f"distance {dist['editDistance']}")
            print(f"NW 262,144 bp x {len(t)} bp: d={cost}; the CIGAR is a valid alignment of "
                  "cost d, equal to the k=-1 distance")
            semi_runs(s["tq"], s["big_t"], "auto", 3)

        got = drive("align_scale: 262,144 bp NW path and distance; 4 kbp x 1 Mbp SHW/HW", main_runs)
        bad = [k for k in banded_kernels if got[k] <= 0]  # K4, K5 and K6: their warp routes
        if bad:
            raise AssertionError(f"align_scale: kernels of the path not launched: {bad}")
        if got["banded_final_column_wide"] or got["banded_myers_wide"] or got["semi_ends_wide"]:
            raise AssertionError(f"align_scale: a wide route launched: {got}")
        launches.update({k: got[k] for k in banded_kernels})
        # the same workloads cut to sizes the scan route finishes: identical results
        try:
            al.MOVES_CELL_LIMIT = 1 << 12
            got = {}
            for route in ("auto", "scan"):
                banded.DEFAULT_BACKEND = route
                got[route] = walls(f"NW path 8,192 bp, MOVES_CELL_LIMIT 2^12 [{route}]",
                                   lambda: al.align(s["q8"], s["t8"], mode="NW", task="path",
                                                    device="cuda"), 1)
            al.MOVES_CELL_LIMIT = 1 << 22
            # K6's HW segments patched down to 64 columns: 128 seams a sweep
            banded_cuda.segment_plan = lambda P, Lq, Lt, sms, resident: (-(-Lt // 64), 64)
            for route in ("auto", "scan"):
                banded.DEFAULT_BACKEND = route
                got[route] = (got[route], semi_runs(s["tq"], s["big_t"][: 1 << 13], route, 1,
                                                    ks=(64, 256)))
        finally:
            banded.DEFAULT_BACKEND = "auto"
            al.MOVES_CELL_LIMIT = 1 << 22
            banded_cuda.segment_plan = segment_plan
        if got["auto"] != got["scan"]:
            raise AssertionError("cut sizes: the kernel and scan routes differ")
        print("align_scale: 8,192 bp path and 4 kbp x 8 kbp SHW/HW (K6's HW in segments of 64 "
              "columns) identical on the kernel and scan routes")

    def banded_times():
        s = scale_pairs()

        def codes(x):
            return torch.from_numpy(encode(x).astype(np.int32)[None, :]).to(dev)

        def lens(*n):
            return torch.tensor(n, dtype=torch.int32, device=dev)

        def pair(qs, ts):
            return [codes(qs), lens(len(qs)), codes(ts), lens(len(ts))]

        # K4: the transposed SHW k=32 sweep of the 4 kbp x 1 Mbp run, on both routes
        k4_shw = pair(s["big_t"][:4129], s["tq"])
        cases = [("banded_final_column", "K4 warp route SHW k=32 transposed: q 4129 bp x t 4096 "
                  "bp", k4_shw, dict(k=32, route="warp"),
                  banded_final_column_cuda, banded.banded_final_column),
                 # K5: the Hirschberg top level's band (kb = 4096), cut to 1024 target columns
                 ("banded_myers", "K5 k=4096: q 5121 bp x t 1024 bp (the 262,144 bp path's "
                  "top-level band, cut)", pair(s["q"][:5121], s["t"][:1024]), dict(k=4096),
                  banded_myers_cuda, banded.banded_final_column_myers),
                 # K6: the HW 4 kbp query, cut to 2048 target columns
                 ("semi_ends", "K6 HW: q 4096 bp x t 2048 bp (the 4 kbp x 1 Mbp HW run, cut)",
                  pair(s["tq"], s["big_t"][:2048]), dict(free_target_prefix=True),
                  semi_ends_cuda, banded.semi_ends_myers)]
        # the wide routes at align_wide's shapes: the 40 kbp pair's band k =
        # 8192 (513 words) cut to 1024 target columns, the 17 kbp HW query
        # (532 words) cut to 2048
        q40, t40, q17, t20 = wide_pairs()
        # K4's wide route at align_wide's mask-mode band k = 8192 (the
        # 40 kbp pair under an equality, as ops/align encodes it: query rows
        # as bitmasks, target rows as compact ids), cut to 1024 columns
        raw = [al._encode_any(x) for x in (q40, t40)]
        enc = al._equality_encoding(raw, [("N", "A")])
        mq, mt = enc.q_lut[raw[0][:9217]], enc.t_lut[raw[1][:1024]].astype(np.int32)
        k4_mask = [torch.from_numpy(mq[None, :]).to(dev), lens(9217),
                   torch.from_numpy(mt[None, :]).to(dev), lens(1024)]
        cases += [("banded_final_column_wide", "K4 wide route mask mode k=8192: q 9217 bp x t "
                   "1024 bp (the 40 kbp mask-mode NW distance's last band, cut)", k4_mask,
                   dict(k=8192, use_mask=True), banded_final_column_cuda,
                   banded.banded_final_column),
                  ("banded_myers_wide", "K5 wide route k=8192: q 9217 bp x t 1024 bp (the 40 kbp "
                   "NW distance's last band, cut)", pair(q40[:9217], t40[:1024]), dict(k=8192),
                   banded_myers_cuda, banded.banded_final_column_myers),
                  ("semi_ends_wide", "K6 wide route HW: q 17000 bp x t 2048 bp (the 17 kbp HW "
                   "run, cut)", pair(q17, t20[:2048]), dict(free_target_prefix=True),
                   semi_ends_cuda, banded.semi_ends_myers)]
        def out_bytes(x):
            if isinstance(x, (tuple, list)):
                return sum(out_bytes(y) for y in x)
            return x.numel() * x.element_size() if torch.is_tensor(x) else 0

        for name, what, args, kw, kern, plain in cases:
            k, got = timed(lambda: kern(*args, **kw), 5)
            p, want = timed(lambda: plain(*args, **{a: v for a, v in kw.items() if a != "route"}), 0)
            smoke.same(name, what, got, want)
            timing[name] = (statistics.median(k), statistics.median(p))
            q_len, t_len = int(args[1][0]), int(args[3][0])
            if name.startswith("banded_final_column"):  # the band's cells
                ops = OPS_PER_CELL["hw"] * band_rows(q_len, t_len, kw["k"]).sum()
            elif name.startswith("banded_myers"):  # the band's cells in 32-row words
                words = -(-band_rows(q_len, t_len, kw["k"]) // 32)
                ops = OPS_PER_CELL["myers_word"] * words.sum()
            else:  # full-height words x target columns
                ops = OPS_PER_CELL["semi_word"] * -(-q_len // 32) * t_len
            bounds[name] = bound(4 * (q_len + t_len + 2) + out_bytes(got), ops)
            print(f"{what}: kernel {spread(k)}, {1e6 * statistics.median(k) / t_len:.1f} ns a "
                  f"target column; plain {spread(p)}; bound {bounds[name][0]:.4f} ms "
                  f"({bounds[name][1]})")
        # the whole 40 kbp band (align_wide's last k-doubling level, k = 8,192):
        # K4's wide route in mask mode and K5's, kernel only
        mq40, mt40 = enc.q_lut[raw[0]], enc.t_lut[raw[1]].astype(np.int32)
        k4_whole = [torch.from_numpy(mq40[None, :]).to(dev), lens(len(q40)),
                    torch.from_numpy(mt40[None, :]).to(dev), lens(len(t40))]
        for name, fn, args, kw in (("K4 wide route mask mode", banded_final_column_cuda, k4_whole,
                                    dict(k=8192, use_mask=True)),
                                   ("K5 wide route", banded_myers_cuda, pair(q40, t40),
                                    dict(k=8192))):
            k, _ = timed(lambda: fn(*args, **kw), 3)
            print(f"{name} k=8192, the whole 40 kbp pair (q {len(q40)} bp x t {len(t40)} bp): "
                  f"kernel {spread(k)}, {1e6 * statistics.median(k) / len(t40):.1f} ns a target "
                  "column")
        # align_wide's NW distance of the 40 kbp pair end to end, plain codes
        # (K4's warp route, then K5's warp and wide routes) and mask mode (K4)
        for what, kw in (("plain", {}), ("mask mode", dict(additionalEqualities=[("N", "A")]))):
            walls = []
            d = al.align(q40, t40, mode="NW", device="cuda", **kw)["editDistance"]
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d2 = al.align(q40, t40, mode="NW", device="cuda", **kw)["editDistance"]
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if d2 != d:
                    raise AssertionError(f"align_wide {what}: distance {d2} != {d}")
            print(f"align_wide NW distance 40 kbp {what} (d={d}): wall s min / median / max "
                  f"{min(walls):.4f} / {statistics.median(walls):.4f} / {max(walls):.4f}")
        # K4's wide route forced at the warp route's SHW k = 32 shape, for
        # comparison only (auto takes the warp route there)
        k, got = timed(lambda: banded_final_column_cuda(*k4_shw, k=32, route="wide"), 5)
        smoke.same("banded_final_column_wide", "K4 wide route forced, SHW k=32", got,
                   banded.banded_final_column(*k4_shw, k=32))
        print(f"K4 wide route forced, SHW k=32 transposed: q 4129 bp x t 4096 bp: kernel "
              f"{spread(k)}, {1e6 * statistics.median(k) / 4096:.1f} ns a target column")
        # K4 at a Hirschberg level's batch: 64 pairs of 2,048 bp at 1 %
        # divergence (numpy seed 1, banded_ab.py's), k = 32, both routes
        r = np.random.default_rng(1)
        pairs = [synth_pair(2048, 0.01, r) for _ in range(64)]
        batch = []
        for side in (0, 1):
            seqs = [encode(x[side]).astype(np.int32) for x in pairs]
            arr = np.zeros((64, max(len(x) for x in seqs)), dtype=np.int32)
            for i, x in enumerate(seqs):
                arr[i, : len(x)] = x
            batch += [torch.from_numpy(arr).to(dev), lens(*[len(x) for x in seqs])]
        want = banded.banded_final_column(*batch, k=32)
        cells = sum(int(band_rows(int(a), int(b), 32).sum())
                    for a, b in zip(batch[1].tolist(), batch[3].tolist()))
        bd = bound(4 * sum(x.numel() for x in batch) + 4 * want.numel(), OPS_PER_CELL["hw"] * cells)
        for name, route in (("banded_final_column", "warp"), ("banded_final_column_wide", "wide")):
            k, got = timed(lambda: banded_final_column_cuda(*batch, k=32, route=route), 5)
            smoke.same(name, f"K4 {route} route, 64 pairs x 2048 bp, k=32", got, want)
            print(f"K4 {route} route k=32, 64 pairs of ~2048 bp (a Hirschberg level's batch): "
                  f"kernel {spread(k)}, {1e6 * statistics.median(k) / batch[2].shape[1]:.1f} ns a "
                  f"target column; bound {bd[0]:.4f} ms ({bd[1]})")
        # K6's wide route on the 17 kbp x 1 Mbp HW run: the plan's segments and one block
        wide_full = wide_scale_pair()
        wplan = wide_plan(wide_full)
        n = wide_full[2].shape[1]
        for what, kw in ((f"the plan's {wplan[0]} segments of {wplan[1]} columns", {}),
                         ("one block", dict(seg_cols=0))):
            k, got = timed(lambda: semi_ends_cuda(*wide_full, **kw), 2)
            bd = bound(4 * (17000 + n + 2) + out_bytes(got),
                       OPS_PER_CELL["semi_word"] * -(-17000 // 32) * n)
            print(f"K6 wide route HW at {what}, q 17000 bp x t {n} bp: kernel {spread(k)}, "
                  f"{1e6 * statistics.median(k) / n:.2f} ns a target column; bound {bd[0]:.4f} ms "
                  f"({bd[1]}), {100 * bd[0] / statistics.median(k):.2f} % of it")
        # the one-pair sweeps of the uncut runs, kernel only
        k4_full = pair(s["q"], s["t"])
        for name, fn in (("K5", banded_myers_cuda), ("K4", banded_final_column_cuda)):
            k, _ = timed(lambda: fn(*k4_full, k=128), 2)
            print(f"{name} k=128, q {len(s['q'])} bp x t {len(s['t'])} bp (the k-doubling's first "
                  f"band, K5's since MYERS_MIN_K = 128): kernel {spread(k)}, "
                  f"{1e6 * statistics.median(k) / len(s['t']):.1f} ns a target column")
        k, _ = timed(lambda: banded_myers_cuda(*k4_full, k=4096), 2)
        print(f"K5 k=4096, q {len(s['q'])} bp x t {len(s['t'])} bp: kernel {spread(k)}, "
              f"{1e6 * statistics.median(k) / len(s['t']):.1f} ns a target column")
        k6_full = pair(s["tq"], s["big_t"])
        n = len(s["big_t"])
        plan = segment_plan(1, 4096, n, *banded_cuda._card_warps(0, 128))
        # the bound of the work, full-height words x the target's columns;
        # the segments step (segment columns + a 2 q_len warm-up) each
        words = -(-4096 // 32)
        for what, kw, cols in ((f"HW at the plan's {plan[0]} segments of {plan[1]} columns", {},
                                plan[0] * (plan[1] + 2 * 4096)),
                               ("HW one warp", dict(seg_cols=0), n),
                               ("SHW one warp", dict(free_target_prefix=False), n)):
            k, got = timed(lambda: semi_ends_cuda(*k6_full, **kw), 2)
            nbytes = 4 * (4096 + n + 2) + out_bytes(got)
            bd = bound(nbytes, OPS_PER_CELL["semi_word"] * words * n)
            stepped = bound(nbytes, OPS_PER_CELL["semi_word"] * words * cols)
            print(f"K6 {what}, q 4096 bp x t {n} bp: kernel {spread(k)}, "
                  f"{1e6 * statistics.median(k) / n:.1f} ns a target column; bound {bd[0]:.4f} ms "
                  f"({bd[1]}), {100 * bd[0] / statistics.median(k):.2f} % of it; the {cols} "
                  f"columns the kernel steps: {stepped[0]:.4f} ms")
        # the path task's plain scans at its base-case size: 16 pairs of ~1600 bp
        r = np.random.default_rng(2)
        b = [torch.from_numpy(r.integers(0, 4, (16, 1600)).astype(np.int32)).to(dev)
             for _ in range(2)]
        n16 = torch.full((16,), 1600, dtype=torch.int32, device=dev)
        # their bounds: the codes and lengths read once, the move matrix
        # (uint8, [16, 1601, 1601]) or the last rows (int32, [16, 1601])
        # written once, OPS_PER_CELL["hw"] (the NW recurrence) a cell
        ops = OPS_PER_CELL["hw"] * 16 * 1600 * 1600
        in_bytes = 4 * (2 * b[0].numel() + 2 * n16.numel())
        for name, fn, out_b in (("dp_moves_batch", al.dp_moves_batch, 16 * 1601 * 1601),
                                ("dp_lastrow_batch", al.dp_lastrow_batch, 4 * 16 * 1601)):
            p, _ = timed(lambda: fn(b[0], n16, b[1], n16), 3)
            bd = bound(in_bytes + out_b, ops)
            print(f"{name} (plain, no kernel) 16 pairs x 1600 x 1600: {spread(p)}; bound "
                  f"{bd[0]:.4f} ms ({bd[1]})")

    def k2_times():
        """K2 at the golden finishing shape, every raw block x the 24 DXZ1
        monomers x 2 variants: the cross entry's two launches alone on the
        blocks packed_both builds (sorted by length; homopolymer-collapsed),
        the pairwise entry on the same pairs expanded and on the pairs the
        light-mode run dispatches (its own path's shape), and the whole packed
        call with its prologue; then the cross entry alone at the library's
        width, the same blocks x the 264 monomers."""
        from stringdecomposer_tpu_torch.convert import numpy_state, state_from_numpy
        from stringdecomposer_tpu_torch.ops.identity_cuda import cells_per_lane

        with open(os.path.join(DATA, "raw_decomposition_oracle.tsv")) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        starts = np.array([int(r[2]) for r in rows], dtype=np.int64)
        blens = np.array([int(r[3]) - int(r[2]) + 1 for r in rows], dtype=np.int32)
        read_dev = torch.from_numpy(encode(load_fasta(read_fa)[0].seq)).to(dev)
        order = np.argsort(blens, kind="stable")
        ql = torch.from_numpy(blens[order]).to(dev)
        q = k2_plain.blocks_from_read(read_dev, torch.from_numpy(starts[order]).to(dev), ql,
                                      int(blens.max()))
        qh, hl = k2_plain.homo_collapse(q, ql)
        Nb = len(blens)

        def state(records):
            st = state_from_numpy(*numpy_state([], add_rc_interleaved(records)), dev)
            return st, [x.to(torch.int32).contiguous()
                        for x in (st.t_raw, st.tl_raw, st.t_homo, st.tl_homo)]

        def run_cross(fn, t_raw, tl_raw, t_homo, tl_homo, n=Nb):
            return fn(q[:n], ql[:n], t_raw, tl_raw), fn(qh[:n], hl[:n], t_homo, tl_homo)

        def kernel_bound(t_raw, tl_raw, t_homo, tl_homo, pair_inputs=False):
            """The cross entry's inputs read once (both variants' blocks, the
            monomers, the lengths) and (D, columns) written once; with
            pair_inputs, the pairwise entry's expanded inputs and its three
            outputs instead. OPS_PER_CELL["k2"] per cell of every pair."""
            M = t_raw.shape[0]
            cells = int(ql.sum()) * int(tl_raw.sum()) + int(hl.sum()) * int(tl_homo.sum())
            if pair_inputs:
                nbytes = 4 * M * (q.numel() + qh.numel() + 2 * Nb) + 4 * Nb * (
                    t_raw.numel() + t_homo.numel() + 2 * M) + 2 * Nb * M * 12
            else:
                nbytes = 4 * (q.numel() + qh.numel() + t_raw.numel() + t_homo.numel()
                              + 2 * Nb + 2 * M) + 2 * Nb * M * 8
            return bound(nbytes, OPS_PER_CELL["k2"] * cells)

        st, targets = state(load_fasta(dxz1, upper=True))
        M = targets[0].shape[0]
        k, got = timed(lambda: run_cross(nw_identity_cross_cuda, *targets), 10)
        p, want = timed(lambda: run_cross(k2_plain.nw_identity_cross, *targets), 0)
        for v, name in enumerate(("raw", "homopolymer-compressed")):
            smoke.same("nw_identity_cross", f"golden blocks x DXZ1, {name}", got[v], want[v])
        timing["nw_identity_cross"] = (statistics.median(k), p[0])
        bd = bounds["nw_identity_cross"] = kernel_bound(*targets)
        print(f"K2 cross entry alone (2 launches, C = {cells_per_lane(q.shape[1])} for both "
              f"variants), {Nb} golden blocks x {M} monomers x 2 variants: kernel {spread(k)}; "
              f"plain {p[0]:.3f} ms (1 run); bound {bd[0]:.3f} ms ({bd[1]}), "
              f"{100 * bd[0] / statistics.median(k):.2f} % of it")
        # the pairwise entry on the same pairs, expanded block-major
        exp = [(x.repeat_interleave(M, dim=0), xl.repeat_interleave(M), t.repeat(Nb, 1), tl.repeat(Nb))
               for x, xl, t, tl in ((q, ql, *targets[:2]), (qh, hl, *targets[2:]))]
        k, got = timed(lambda: [nw_identity_batch_cuda(*e) for e in exp], 10)
        p, want = timed(lambda: [k2_plain.nw_identity_batch(*e) for e in exp], 0)
        for v in range(2):
            for i, name in enumerate(("D", "matches", "columns")):
                smoke.same("nw_identity", f"golden pairs expanded, variant {v} {name}",
                           got[v][i], want[v][i])
        bd = kernel_bound(*targets, pair_inputs=True)
        print(f"K2 pairwise entry alone (2 launches), the same {2 * Nb * M} pairs expanded: kernel "
              f"{spread(k)}; plain {p[0]:.3f} ms (1 run); bound {bd[0]:.3f} ms ({bd[1]}), "
              f"{100 * bd[0] / statistics.median(k):.2f} % of it")
        # the pairwise entry at its own path's shape: the (block, best
        # monomer) pairs the golden light-mode run dispatches, as it
        # dispatches them
        light = []

        def grab(*a):
            light.append(a)
            return nw_identity_batch_cuda(*a)

        with tempfile.TemporaryDirectory() as d:
            pipeline.run(read_fa, dxz1, out_dir=d, device="cuda", identity_fn=grab)
        k, got = timed(lambda: [nw_identity_batch_cuda(*a) for a in light], 10)
        p, want = timed(lambda: [k2_plain.nw_identity_batch(*a) for a in light], 0)
        for g, w in zip(got, want):
            for i, name in enumerate(("D", "matches", "columns")):
                smoke.same("nw_identity", f"light-mode pairs {name}", g[i], w[i])
        timing["nw_identity"] = (statistics.median(k), p[0])
        cells = sum(int((ql.to(torch.int64) * tl).sum()) for _, ql, _, tl in light)
        nbytes = sum(sum(x.numel() * x.element_size() for x in a) + 3 * 4 * a[0].shape[0]
                     for a in light)
        bd = bounds["nw_identity"] = bound(nbytes, OPS_PER_CELL["k2"] * cells)
        print(f"K2 pairwise entry alone ({len(light)} launch(es)), light mode's "
              f"{sum(a[0].shape[0] for a in light)} (block, best monomer) pairs: kernel "
              f"{spread(k)}; plain {p[0]:.3f} ms (1 run); bound {bd[0]:.4f} ms ({bd[1]}), "
              f"{100 * bd[0] / statistics.median(k):.2f} % of it")
        pargs = (read_dev, starts, blens, st.t_raw, st.tl_raw, st.t_homo, st.tl_homo)
        kw = dict(n_pad=Nb, Lq=int(blens.max()))
        k, got = timed(lambda: nw_identity_packed_both(*pargs, **kw), 10)
        p, want = timed(lambda: k2_plain.nw_identity_packed_both_plain(*pargs, **kw), 0)
        smoke.same("nw_identity_cross", "golden shape packed_both", got, want)
        print(f"K2 packed call (nw_identity_packed_both: prologue + the cross entry), {Nb} blocks x "
              f"{M} monomers x 2 variants: {spread(k)}; plain {p[0]:.3f} ms (1 run)")
        # the library's width: the same blocks x 264 monomers
        _, lib = state([Record(r.name, r.seq.upper()) for r in library])
        k, got = timed(lambda: run_cross(nw_identity_cross_cuda, *lib), 5)
        want = run_cross(k2_plain.nw_identity_cross, *lib, n=64)
        for v in range(2):
            smoke.same("nw_identity_cross", f"library width, variant {v}, first 64 blocks",
                       got[v][:64], want[v])
        bd = kernel_bound(*lib)
        print(f"K2 cross entry alone, {Nb} golden blocks x {lib[0].shape[0]} library monomers x 2 "
              f"variants (the library's width): kernel {spread(k)}; bound {bd[0]:.3f} ms "
              f"({bd[1]}), {100 * bd[0] / statistics.median(k):.2f} % of it")

    def all_times():
        kernel_times()
        k2_times()
        banded_times()

    phases = [
        ("setup", setup), ("k1", k1_checks), ("k2", k2_checks), ("golden", golden_run),
        ("joined", joined_runs), ("chunked", chunked_run), ("scale", scale_run),
        ("k3", k3_checks), ("ed_thr", ed_thr_run), ("ed_thr_long", ed_thr_long),
        ("library", library_run), ("modes", modes_run), ("parallel", parallel_run),
        ("k4", k4_checks), ("k5", k5_checks),
        ("k6", k6_checks), ("align_wide", align_wide), ("align", align_checks),
        ("align_scale", align_scale), ("p_probe", probe_checks), ("k1_int16", k1_int16_run),
        ("ablate", ablate_run), ("times", all_times)
    ]
    unknown = sorted(set(only) - {n for n, _ in phases})
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}", file=sys.stderr)
        return 2
    for name, fn in phases:
        if not only or name == "setup" or name in only:
            smoke.phase(name, fn)
    work.cleanup()
    if smoke.failed:
        print(f"chip_smoke: FAILED phases: {', '.join(smoke.failed)}")
        return 1
    if only:
        print(f"chip_smoke: setup and {', '.join(only)} passed; no result without every phase")
        return 0
    src = "stringdecomposer_tpu_torch/csrc/"
    meta = [("chain_dp", src + "chain_dp.cuh", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131"),
            ("chain_dp_large", src + "chain_dp.cuh", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131"),
            ("block_walk", src + "chain_dp.cu", "stringdecomposer_tpu/ops/chain_dp.py:165"),
            ("nw_identity", src + "nw_identity.cu", "stringdecomposer_tpu/ops/identity_pallas.py:63"),
            ("nw_identity_cross", src + "nw_identity.cu",
             "stringdecomposer_tpu/ops/identity_pallas.py:63"),
            ("hw_filter", src + "hw_filter.cu", "stringdecomposer_tpu/ops/hw_filter.py:80"),
            ("hw_filter_warp", src + "hw_filter.cu", "stringdecomposer_tpu/ops/hw_filter.py:80"),
            ("hw_filter_wide", src + "hw_filter.cu", "stringdecomposer_tpu/ops/hw_filter.py:80"),
            ("banded_final_column", src + "banded_warp.cu",
             "stringdecomposer_tpu/ops/banded_pallas.py:59"),
            ("banded_final_column_wide", src + "banded.cu",
             "stringdecomposer_tpu/ops/banded_pallas.py:59"),
            ("banded_myers", src + "myers_warp.cu", "stringdecomposer_tpu/ops/banded_pallas.py:241"),
            ("semi_ends", src + "myers_warp.cu", "stringdecomposer_tpu/ops/banded_pallas.py:510"),
            ("banded_myers_wide", src + "banded.cu", "stringdecomposer_tpu/ops/banded_pallas.py:241"),
            ("semi_ends_wide", src + "banded.cu", "stringdecomposer_tpu/ops/banded_pallas.py:510")]
    meta += [("int16_probe", src + "chain_dp.cu", "stringdecomposer_tpu/ops/chain_dp_pallas.py:106"),
             ("chain_dp_int16", src + "chain_dp.cuh", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131"),
             ("chain_dp_large_int16", src + "chain_dp.cuh",
              "stringdecomposer_tpu/ops/chain_dp_pallas.py:131")]
    meta += [(n, src + "chain_dp_lanes.cuh", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131")
             for n in ("chain_dp_lanes", "chain_dp_lanes_int16", "chain_dp_lanes_long",
                       "chain_dp_lanes_long_int16")]
    meta += [(n, src + "chain_dp_cluster.cuh", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131")
             for n in ("chain_dp_cluster", "chain_dp_cluster_int16", "chain_dp_cluster_long",
                       "chain_dp_cluster_long_int16")]
    meta += [(n, src + "chain_dp_tiled.cu", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131")
             for n in ("chain_dp_tiled", "chain_dp_tiled_int16", "chain_dp_cluster_tiled",
                       "chain_dp_cluster_tiled_int16")]
    meta += [(n, src + ("chain_dp.cuh" if n.endswith("_base") else "chain_dp_ablate.cu"),
              "scripts/ablate_chain.py:31") for n in ABLATE]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": s, "replaces": r, "launches": launches[n],
         "max_abs_err": smoke.max_err[n], "ms": timing[n][0], "plain_ms": timing[n][1],
         "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": None}
        for n, s, r in meta]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
