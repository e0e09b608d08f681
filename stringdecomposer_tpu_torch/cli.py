"""Command-line interface of the PyTorch port, ported from
stringdecomposer_tpu/cli.py. The eleven reference flags (main.py:201-245)
keep their names and defaults; `--device-batch` and `--device` are added.
The JAX package's one-process run modes (`--stream-reads`, `--resume`,
`--serve` with `--precompile`, `--profile-dir`) are served; its flags of
more than one GPU or host are parsed and refused with a clear message,
never ignored.

Usage:
    python -m stringdecomposer_tpu_torch <sequences.fa> <monomers.fa> [options]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import traceback
from contextlib import nullcontext

NOT_PORTED = "not yet ported to stringdecomposer_tpu_torch (see ROADMAP.md)"


def build_parser() -> argparse.ArgumentParser:
    from .__version__ import __version__

    p = argparse.ArgumentParser(
        prog="stringdecomposer-tpu-torch",
        description="Decomposes string into blocks alphabet (PyTorch / CUDA)",
    )
    p.add_argument("--version", action="version",
                   version=f"stringdecomposer-tpu-torch {__version__}")
    p.add_argument("sequences", help="fasta-file with long reads or genomic sequences")
    p.add_argument("monomers", help="fasta-file with monomers")
    p.add_argument("-t", "--threads", default="1", required=False,
                   help="host threads for the finishing stage's encode/dispatch")
    p.add_argument("-o", "--out-dir", default=".", required=False,
                   help="output directory (by default .)")
    p.add_argument("--out-file", default="final_decomposition", required=False,
                   help='output tsv-file (by default "final_decomposition")')
    p.add_argument("-i", "--min-identity", type=int, default=0, required=False,
                   help="only monomer alignments with percent identity >= MIN_IDENTITY "
                   "are printed (by default MIN_IDENTITY=0)")
    p.add_argument("-s", "--scoring", default="-1,-1,-1,1", required=False,
                   help='scoring scheme "insertion,deletion,mismatch,match" '
                   '(default "-1,-1,-1,1"); honored by the DP')
    p.add_argument("-b", "--batch-size", type=str, default="5000", required=False,
                   help="window size for long-read chunking (by default 5000)")
    p.add_argument("--second-best", dest="second_best", action="store_true",
                   help="generate second best monomer and homopolymer scores")
    p.add_argument("--ed_thr", type=int, default=-1, required=False,
                   help="align only monomers with edit distance less than ed_thr for "
                   "each segment (by default align all monomers)")
    p.add_argument("-v", "--overlap", type=str, default="500", required=False,
                   help="window overlap (halo) size (by default 500)")
    p.add_argument("--device-batch", type=int, default=64,
                   help="windows per kernel launch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the hand-written kernels; default) or cpu "
                   "(the plain PyTorch twins)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--resume", action="store_true",
                   help="reuse an existing raw TSV whose stamp matches the inputs "
                   "instead of recomputing the DP stage")
    p.add_argument("--stream-reads", type=int, default=0,
                   help="process reads in groups of N with incremental "
                   "output (bounded memory for flowcell-scale FASTAs)")
    p.add_argument("--serve", action="store_true",
                   help="serving mode: read one job per stdin line "
                   "(same arguments, no program name), keep the kernels loaded "
                   "across jobs, emit one JSON status line per job")
    p.add_argument("--precompile", metavar="MONOMERS_FA", default=None,
                   help="(with --serve) run a warm-up job for this monomer set "
                   "before accepting jobs, so that no job pays the kernels' "
                   "first build, load or launch")
    unported = p.add_argument_group(f"flags of stringdecomposer_tpu {NOT_PORTED}")
    for flag, default in (("--num-hosts", 1), ("--host-id", 0), ("--num-processes", None)):
        unported.add_argument(flag, type=int, default=default)
    unported.add_argument("--coordinator", default=None)
    unported.add_argument("--data-parallel", action="store_true")
    return p


def _unported_flags(args) -> list[str]:
    checks = [
        ("--data-parallel", args.data_parallel),
        ("--coordinator", args.coordinator is not None), ("--num-hosts", args.num_hosts > 1),
        ("--host-id", args.host_id != 0),
        ("--num-processes", args.num_processes not in (None, 1)),
    ]
    return [flag for flag, used in checks if used]


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in argv:
        argv.remove("--serve")
        return serve(argv)
    return _execute(build_parser().parse_args(argv))


def serve(default_argv: list[str]) -> int:
    """Serving mode: one process, jobs streamed on stdin.

    Each line is a CLI invocation without the program name
    (`seqs.fa monomers.fa -o out [flags...]`); flags passed alongside
    --serve apply to every job. One JSON status line per job on stdout. The
    kernel library, the CUDA context and the kernels' first launches stay
    warm across jobs; --precompile MONOMERS_FA warms them before the first.
    A job that fails reports its error and the server goes on."""
    import json
    import shlex

    if "--precompile" in default_argv:
        i = default_argv.index("--precompile")
        warm_monomers = default_argv[i + 1]
        del default_argv[i : i + 2]
        # the serve-level flags that shape the warm-up; job lines inherit them
        pre = argparse.ArgumentParser(add_help=False)
        pre.add_argument("--device-batch", type=int, default=64)
        pre.add_argument("-b", "--batch-size", type=str, default="5000")
        pre.add_argument("-v", "--overlap", type=str, default="500")
        pre.add_argument("--second-best", action="store_true")
        pre.add_argument("-s", "--scoring", default="-1,-1,-1,1")
        pre.add_argument("-t", "--threads", default="1")
        pre.add_argument("--device", default="cuda")
        ns, _ = pre.parse_known_args(default_argv)
        from .pipeline import precompile_menu

        precompile_menu(warm_monomers, device_batch=ns.device_batch,
                        batch_size=int(ns.batch_size), overlap=int(ns.overlap),
                        second_best=ns.second_best, scoring=ns.scoring,
                        threads=max(1, int(ns.threads)), device=ns.device)

    parser = build_parser()
    for line in sys.stdin:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            args = parser.parse_args(shlex.split(line) + default_argv)
            rc = _execute(args)
            print(json.dumps({"status": "ok" if rc == 0 else "error", "rc": rc,
                              "final": os.path.join(args.out_dir, args.out_file + ".tsv")}),
                  flush=True)
        except SystemExit as e:  # argparse error on this job line
            print(json.dumps({"status": "error", "rc": int(e.code or 2),
                              "error": "bad arguments"}), flush=True)
        except Exception as e:  # noqa: BLE001 - report the job, keep serving
            traceback.print_exc(file=sys.stderr)
            print(json.dumps({"status": "error", "rc": 1, "error": str(e)}), flush=True)
    return 0


def _execute(args) -> int:
    bad = _unported_flags(args)
    if bad:
        print(f"stringdecomposer-tpu-torch: {', '.join(bad)}: {NOT_PORTED}", file=sys.stderr)
        return 2
    pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)

    from .io.fasta import InvalidSymbolError
    from .pipeline import run
    from .utils.logging import get_logger

    logger = get_logger(os.path.join(args.out_dir, "stringdecomposer.log"), logger_name="SD-TPU")
    logger.info("cmd: %s", sys.argv)
    profiler = nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if args.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities,
                           on_trace_ready=tensorboard_trace_handler(args.profile_dir))
    try:
        with profiler:
            run(
                args.sequences,
                args.monomers,
                out_dir=args.out_dir,
                out_file=args.out_file,
                min_identity=args.min_identity,
                scoring=args.scoring,
                batch_size=int(args.batch_size),
                overlap=int(args.overlap),
                second_best=args.second_best,
                device_batch=args.device_batch,
                device=args.device,
                threads=max(1, int(args.threads)),
                ed_thr=args.ed_thr,
                resume=args.resume,
                stream_reads=args.stream_reads,
            )
    except InvalidSymbolError as e:
        logger.error("ERROR: %s", e)
        return 255  # reference binary exit(-1) semantics (main.cpp:336)
    logger.info("Thank you for using StringDecomposer!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
