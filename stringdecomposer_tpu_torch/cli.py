"""Command-line interface of the PyTorch port, ported from
stringdecomposer_tpu/cli.py. The eleven reference flags (main.py:201-245)
keep their names and defaults; `--device-batch` and `--device` are added.
Every flag of the JAX package's CLI is served with its meaning: the run
modes (`--stream-reads`, `--resume`, `--serve` with `--precompile`,
`--profile-dir`), data parallelism over the GPUs (`--data-parallel`) and
multi-host runs by fragment merge (`--num-hosts`, `--host-id`,
`--coordinator`, `--num-processes`; parallel/multihost.py).

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
    p.add_argument("--data-parallel", action="store_true",
                   help="shard the window batch and the finishing stage's pairs "
                   "across all visible GPUs (of --device)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run here")
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed rendezvous address host:port "
                   "(multi-host; topology is then taken from the process group)")
    p.add_argument("--num-hosts", type=int, default=1,
                   help="number of cooperating hosts (reads are sharded "
                   "round-robin; host 0 merges the fragments)")
    p.add_argument("--host-id", type=int, default=0,
                   help="this host's index in [0, num-hosts)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="process count for --coordinator (defaults to WORLD_SIZE)")
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
    return p


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
    pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)

    from .io.fasta import InvalidSymbolError
    from .pipeline import run
    from .utils.logging import get_logger

    logger = get_logger(os.path.join(args.out_dir, "stringdecomposer.log"), logger_name="SD-TPU")
    logger.info("cmd: %s", sys.argv)
    multihost_mode = args.coordinator is not None or args.num_hosts > 1
    kernels = {}
    if args.data_parallel and not multihost_mode:
        # a multi-host run builds its own sharded kernels after the
        # torch.distributed bring-up
        from .parallel.mesh import get_devices
        from .parallel.sharding import (
            make_sharded_forward, make_sharded_identity, make_sharded_packed,
        )

        devices = get_devices(args.device)
        kernels = dict(forward_fn=make_sharded_forward(devices),
                       identity_fn=make_sharded_identity(devices),
                       packed_fn=make_sharded_packed(devices))
    common = dict(out_dir=args.out_dir, out_file=args.out_file, min_identity=args.min_identity,
                  scoring=args.scoring, batch_size=int(args.batch_size),
                  overlap=int(args.overlap), second_best=args.second_best,
                  device_batch=args.device_batch, device=args.device,
                  threads=max(1, int(args.threads)), ed_thr=args.ed_thr, resume=args.resume,
                  stream_reads=args.stream_reads)
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
            if multihost_mode:
                from .parallel.multihost import HostTopology, run_multihost

                run_multihost(args.sequences, args.monomers,
                              topology=HostTopology(args.num_hosts, args.host_id),
                              coordinator=args.coordinator, num_processes=args.num_processes,
                              process_id=args.host_id if args.coordinator else None,
                              data_parallel=args.data_parallel, **common)
            else:
                run(args.sequences, args.monomers, **common, **kernels)
    except InvalidSymbolError as e:
        logger.error("ERROR: %s", e)
        return 255  # reference binary exit(-1) semantics (main.cpp:336)
    logger.info("Thank you for using StringDecomposer!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
