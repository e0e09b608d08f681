#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (stringdecomposer_tpu_torch) on one GPU.

Builds the hand-written kernels from csrc/, checks each against its plain
PyTorch twin on the card (bit-equal: all outputs are integers) and against
the reference fixtures, drives the golden CLI run through the kernels and
a 1.6 Mbp synthetic assembly through both routes, then times each kernel
beside its plain version at the golden shapes.

Usage: python3 chip_smoke.py        (needs one CUDA device; exits non-zero
without one, and prints no result)
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "stringdecomposer_tpu", "test_data")
FIXTURES = os.path.join(HERE, "tests", "fixtures")


class Smoke:
    def __init__(self):
        self.failed: list[str] = []
        self.max_err: dict[str, int] = {"chain_dp": 0, "block_walk": 0, "nw_identity": 0}

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
    result of the warm-up call."""
    import torch

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


def main() -> int:
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

    from stringdecomposer_tpu.io.fasta import (
        Record, add_reverse_complement, encode, load_fasta, pad_monomers,
    )
    from stringdecomposer_tpu.ops.oracle import Scoring, make_windows
    from stringdecomposer_tpu.report import format_raw_rows
    from stringdecomposer_tpu_torch import cli, pipeline
    from stringdecomposer_tpu_torch.finishing import homo_compress
    from stringdecomposer_tpu_torch.ops import chain_dp as k1_plain
    from stringdecomposer_tpu_torch.ops import identity as k2_plain
    from stringdecomposer_tpu_torch.ops.chain_dp_cuda import (
        block_walk_cuda, chain_dp_forward_cuda,
    )
    from stringdecomposer_tpu_torch.ops.identity_cuda import (
        nw_identity_batch_cuda, nw_identity_packed_both,
    )
    from stringdecomposer_tpu_torch.runtime import build

    dev = torch.device("cuda")
    smoke = Smoke()
    kind = torch.cuda.get_device_name(0)
    timing: dict[str, tuple[float, float]] = {}
    launches: dict[str, int] = {}

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
        for ln in (path.parent / "build.log").read_text().splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                print("  ptxas:", ln.strip())
        # the reused host formatter builds on first use too; build it here so
        # that the golden timing below measures the run, not g++
        from stringdecomposer_tpu.runtime.native import load_native

        t0 = time.perf_counter()
        native = load_native() is not None
        print(f"native host library: {'ready' if native else 'unavailable (Python fallbacks)'} "
              f"in {time.perf_counter() - t0:.2f} s")

    def mono_set(records):
        monos = add_reverse_complement(records)
        L = (max(len(m.seq) for m in monos) + 7) // 8 * 8
        return monos, pad_monomers(monos, pad_to=L)

    def k1_case(windows_np, wlens_np, mono_np, lens_np, sc, what, max_blocks=0):
        args = [torch.from_numpy(a).to(dev) for a in (windows_np, wlens_np, mono_np, lens_np)]
        kw = dict(ins=sc[0], dele=sc[1], mismatch=sc[2], match=sc[3],
                  max_blocks=max_blocks, return_debug=True)
        bk, ck, (chk, ek, sk) = chain_dp_forward_cuda(*args, **kw)
        bp, cp, (chp, ep, spp) = k1_plain.chain_dp_forward(*args, **kw)
        torch.cuda.synchronize()
        smoke.same("chain_dp", f"{what} end", ek, ep)
        smoke.same("chain_dp", f"{what} spend", sk, spp)
        smoke.same("chain_dp", f"{what} chain", chk, chp)
        smoke.same("block_walk", f"{what} blocks", bk, bp)
        smoke.same("block_walk", f"{what} counts", ck, cp)
        return ck

    def k1_checks():
        import numpy.random as npr

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
            k1_case(wb, wl, mono, lens, case["scoring"], f"fixture {idx}")
            n_win += len(wins)
            cfg = pipeline.PipelineConfig(scoring=Scoring(*case["scoring"]),
                                          part_size=case["part_size"],
                                          overlap=case["overlap"], device_batch=3)
            res = pipeline.decompose_reads([Record(n, s) for n, s in reads], monos, cfg, "cuda")
            names = [m.name for m in monos]
            raw = "".join(r + "\n" for rn, b in res for r in format_raw_rows(rn, b, names))
            if raw != case["raw"]:
                raise AssertionError(f"fixture {idx}: raw TSV differs from the reference binary")
        print(f"K1: {len(cases)} fixture cases ({n_win} windows) bit-equal to the plain twin; "
              f"raw strings equal to the reference binary's")
        rng = npr.default_rng(7)
        alpha = np.array(list("ACGT"))

        def rand_monos(M2, lo, hi):
            return [Record(f"m{j}", "".join(rng.choice(alpha, int(rng.integers(lo, hi)))))
                    for j in range(M2)]

        def rand_windows(fwd, B, W):
            wins = []
            for _ in range(B):
                unit = fwd[int(rng.integers(len(fwd)))].seq
                arr = np.array(list((unit * (W // len(unit) + 2))[: int(rng.integers(W // 2, W + 1))]))
                idx = rng.integers(0, len(arr), max(1, len(arr) // 10))
                arr[idx] = rng.choice(alpha, len(idx))
                wins.append(encode("".join(arr)))
            return k1_plain.build_window_batch(wins, W)

        shapes = [("golden-like M=24 L=192", 12, 150, 187, 6, 1200),
                  ("M=128 L=40 W=96", 64, 20, 40, 4, 96),
                  ("M=128 L=192", 64, 150, 190, 3, 600)]
        for what, nf, lo, hi, B, W in shapes:
            fwd = rand_monos(nf, lo, hi)
            _, (mono, lens) = mono_set(fwd)
            wb, wl = rand_windows(fwd, B, W)
            k1_case(wb, wl, mono, lens, (-1, -1, -1, 1), what)
            # per-window [B, M, L] form: a different monomer order per
            # window, and the last rows masked to length 0
            perm = np.stack([rng.permutation(len(lens)) for _ in range(B)])
            mono_w, lens_w = mono[perm], lens[perm].copy()
            lens_w[:, -2:] = 0
            k1_case(wb, wl, mono_w, lens_w, (-2, -1, -1, 2), what + " per-window")
            counts = k1_case(wb, wl, mono, lens, (-1, -2, -1, 1), what + " max_blocks=1", max_blocks=1)
            if int(counts.max()) <= 1:
                raise AssertionError(f"{what}: the overflow case did not overflow")
        print("K1: random shapes (shared and per-window monomers, M=128, max_blocks=1 "
              "overflow) bit-equal to the plain twin")

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
            q, ql = batch(qs)
            t, tl = batch(ts)
            got = nw_identity_batch_cuda(q, ql, t, tl)
            want = k2_plain.nw_identity_batch(q, ql, t, tl)
            for name_, g, w in zip(("D", "matches", "columns"), got, want):
                smoke.same("nw_identity", f"{what} {name_}", g, w)
            return [x.cpu().numpy() for x in got]

        D, mt, cols = both([c["q"] for c in cases], [c["t"] for c in cases], "edlib fixtures")
        for i, c in enumerate(cases):
            ops = re.findall(r"(\d+)([=XIDM])", c["cigar"])
            want = (int(c["ed"]), sum(int(n) for n, op in ops if op == "="),
                    sum(int(n) for n, _ in ops))
            if (int(D[i]), int(mt[i]), int(cols[i])) != want:
                raise AssertionError(f"edlib case {i}: got {(D[i], mt[i], cols[i])}, want {want}")
        print(f"K2: {len(cases)} edlib fixture cases equal to edlib (ed, matches, columns) "
              "and bit-equal to the plain twin")
        rng = np.random.default_rng(3)

        def rs(n):
            return "".join(rng.choice(list("ACGT"), n))

        qs = ["A", "", "ACGT" * 8, "G" * 17, "ACGT", rs(126), rs(1), rs(126), rs(4500)]
        ts = ["", "ACG", "ACGT" * 8, "G" * 16, "T", rs(1), rs(126), rs(128), rs(4200)]
        both(qs, ts, "edge lengths (tlen 0, qlen 0, skews, 4500 x 4200)")
        print("K2: edge lengths and a 4500 x 4200 pair bit-equal to the plain twin")
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
        smoke.same("nw_identity", "packed_both",
                   nw_identity_packed_both(*args, n_pad=16, Lq=256),
                   k2_plain.nw_identity_packed_both_plain(*args, n_pad=16, Lq=256))
        print("K2: nw_identity_packed_both bit-equal to its plain version")

    golden = {}

    def golden_run():
        counters = (chain_dp_forward_cuda, block_walk_cuda, nw_identity_batch_cuda)
        with tempfile.TemporaryDirectory() as out:
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            rc = cli.main([os.path.join(DATA, "read.fa"), os.path.join(DATA, "DXZ1_star_monomers.fa"),
                           "-o", out, "--second-best"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches.update(chain_dp=chain_dp_forward_cuda.launches,
                            block_walk=block_walk_cuda.launches,
                            nw_identity=nw_identity_batch_cuda.launches)
            if rc != 0:
                raise AssertionError(f"CLI exit code {rc}")
            for got, want in (("final_decomposition_raw.tsv", "raw_decomposition_oracle.tsv"),
                              ("final_decomposition.tsv", "final_decomposition_fc89af8.tsv")):
                with open(os.path.join(out, got), "rb") as f1, open(os.path.join(DATA, want), "rb") as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"{got} differs from {want}")
            with open(os.path.join(out, "stringdecomposer.log")) as f:
                if "Thank you for using StringDecomposer!" not in f.read():
                    raise AssertionError("log sentinel missing")
            with open(os.path.join(out, "final_decomposition_raw.tsv")) as f:
                n_rows = sum(1 for _ in f)
            # the same run with four finishing threads sharing the card
            out4 = os.path.join(out, "t4")
            rc = cli.main([os.path.join(DATA, "read.fa"), os.path.join(DATA, "DXZ1_star_monomers.fa"),
                           "-o", out4, "--second-best", "-t", "4"])
            if rc != 0:
                raise AssertionError(f"CLI -t 4 exit code {rc}")
            for name in ("final_decomposition_raw.tsv", "final_decomposition.tsv",
                         "final_decomposition_alt.tsv"):
                with open(os.path.join(out, name), "rb") as f1, open(os.path.join(out4, name), "rb") as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"-t 4: {name} differs from the -t 1 run")
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the path was not launched: {launches}")
        golden.update(seconds=dt, rows=n_rows)
        print(f"golden: raw TSV == raw_decomposition_oracle.tsv, final TSV == "
              f"final_decomposition_fc89af8.tsv (byte for byte); launches {launches}; "
              f"-t 4 run gives the same three TSVs")
        print(f"golden: e2e {dt:.3f} s, {n_rows} assignments, {n_rows / dt:.1f} raw assignments/s "
              f"(first run in this process, kernels already built)")

    def scale_run():
        sys.path.insert(0, os.path.join(HERE, "scripts"))
        from scale_smoke import synthesize

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

    def kernel_times():
        reads = load_fasta(os.path.join(DATA, "read.fa"))
        monos, (mono, lens) = mono_set(load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa")))
        codes = encode(reads[0].seq)
        wins = [codes[o : o + n] for o, n in make_windows(len(codes), 5000, 500)]
        wb, wl = k1_plain.build_window_batch(wins, 5500)
        args = [torch.from_numpy(a).to(dev) for a in (wb, wl, mono, lens)]
        cap = 5500 // 8
        k, got = timed(lambda: chain_dp_forward_cuda(*args, max_blocks=cap), 5)
        p, want = timed(lambda: k1_plain.chain_dp_forward(*args, max_blocks=cap), 3)
        smoke.same("chain_dp", "golden shape blocks", got[0], want[0])
        smoke.same("chain_dp", "golden shape counts", got[1], want[1])
        timing["chain_dp"] = (statistics.median(k), statistics.median(p))
        print(f"K1 chain_dp + walk, {len(wins)} windows x 5500, M={mono.shape[0]}, L={mono.shape[1]}: "
              f"kernel {spread(k)}; plain {spread(p)}")
        _, _, (_, end, spend) = chain_dp_forward_cuda(*args, max_blocks=cap, return_debug=True)
        k, got = timed(lambda: block_walk_cuda(end, spend, args[1], cap), 10)
        p, want = timed(lambda: k1_plain.block_walk(end, spend, args[1], cap), 3)
        smoke.same("block_walk", "golden shape blocks", got[0], want[0])
        smoke.same("block_walk", "golden shape counts", got[1], want[1])
        timing["block_walk"] = (statistics.median(k), statistics.median(p))
        print(f"walk alone on the same end/spend: kernel {spread(k)}; plain {spread(p)}")
        # K2 at the golden finishing shape: every raw block x 24 monomers x 2 variants
        with open(os.path.join(DATA, "raw_decomposition_oracle.tsv")) as f:
            rows = [ln.split("\t") for ln in f.read().splitlines()]
        starts = np.array([int(r[2]) for r in rows], dtype=np.int64)
        blens = np.array([int(r[3]) - int(r[2]) + 1 for r in rows], dtype=np.int32)
        from stringdecomposer_tpu.io.fasta import add_rc_interleaved
        from stringdecomposer_tpu_torch.convert import numpy_state, state_from_numpy

        fin = add_rc_interleaved(load_fasta(os.path.join(DATA, "DXZ1_star_monomers.fa"), upper=True))
        st = state_from_numpy(*numpy_state([], fin), dev)
        pargs = (torch.from_numpy(codes).to(dev), starts, blens,
                 st.t_raw, st.tl_raw, st.t_homo, st.tl_homo)
        kw = dict(n_pad=len(starts), Lq=int(blens.max()))
        k, got = timed(lambda: nw_identity_packed_both(*pargs, **kw), 5)
        p, want = timed(lambda: k2_plain.nw_identity_packed_both_plain(*pargs, **kw), 3)
        smoke.same("nw_identity", "golden shape packed_both", got, want)
        timing["nw_identity"] = (statistics.median(k), statistics.median(p))
        print(f"K2 packed_both, {len(starts)} blocks x {st.t_raw.shape[0]} monomers x 2 variants: "
              f"kernel {spread(k)}; plain {spread(p)}")
        print("times: every timed kernel output bit-equal to its plain version's")

    smoke.phase("setup", setup)
    smoke.phase("k1", k1_checks)
    smoke.phase("k2", k2_checks)
    smoke.phase("golden", golden_run)
    smoke.phase("scale", scale_run)
    smoke.phase("times", kernel_times)
    if smoke.failed:
        print(f"chip_smoke: FAILED phases: {', '.join(smoke.failed)}")
        return 1
    src = "stringdecomposer_tpu_torch/csrc/"
    meta = [("chain_dp", src + "chain_dp.cu", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131"),
            ("block_walk", src + "chain_dp.cu", "stringdecomposer_tpu/ops/chain_dp.py:165"),
            ("nw_identity", src + "nw_identity.cu", "stringdecomposer_tpu/ops/identity_pallas.py:63")]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": s, "replaces": r, "launches": launches[n],
         "max_abs_err": smoke.max_err[n], "ms": timing[n][0], "plain_ms": timing[n][1]}
        for n, s, r in meta]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
