"""Command-line interface of the PyTorch port, ported from
stringdecomposer_tpu/cli.py. The eleven reference flags (main.py:201-245)
keep their names and defaults; `--device-batch` and `--device` are added.
Flags of the JAX package that this port does not implement yet are parsed
and refused with a clear message, never ignored.

Usage:
    python -m stringdecomposer_tpu_torch <sequences.fa> <monomers.fa> [options]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

NOT_PORTED = "not yet ported to stringdecomposer_tpu_torch (see ROADMAP.md)"


def build_parser() -> argparse.ArgumentParser:
    from stringdecomposer_tpu.__version__ import __version__

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
                   help="align only monomers with edit distance less than ed_thr "
                   f"(by default align all monomers); values >= 0 are {NOT_PORTED}")
    p.add_argument("-v", "--overlap", type=str, default="500", required=False,
                   help="window overlap (halo) size (by default 500)")
    p.add_argument("--device-batch", type=int, default=64,
                   help="windows per kernel launch")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the hand-written kernels; default) or cpu "
                   "(the plain PyTorch twins)")
    unported = p.add_argument_group(f"flags of stringdecomposer_tpu {NOT_PORTED}")
    for flag in ("--stream-reads", "--num-hosts"):
        unported.add_argument(flag, type=int, default=0 if flag == "--stream-reads" else 1)
    for flag in ("--profile-dir", "--coordinator", "--precompile"):
        unported.add_argument(flag, default=None)
    for flag in ("--resume", "--serve", "--data-parallel"):
        unported.add_argument(flag, action="store_true")
    return p


def _unported_flags(args) -> list[str]:
    checks = [
        ("--ed_thr", args.ed_thr >= 0), ("--stream-reads", args.stream_reads > 0),
        ("--serve", args.serve), ("--precompile", args.precompile is not None),
        ("--resume", args.resume), ("--data-parallel", args.data_parallel),
        ("--profile-dir", args.profile_dir is not None),
        ("--coordinator", args.coordinator is not None), ("--num-hosts", args.num_hosts > 1),
    ]
    return [flag for flag, used in checks if used]


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    bad = _unported_flags(args)
    if bad:
        print(f"stringdecomposer-tpu-torch: {', '.join(bad)}: {NOT_PORTED}", file=sys.stderr)
        return 2
    return _execute(args)


def _execute(args) -> int:
    pathlib.Path(args.out_dir).mkdir(parents=True, exist_ok=True)

    from stringdecomposer_tpu.io.fasta import InvalidSymbolError
    from stringdecomposer_tpu.utils.logging import get_logger

    from .pipeline import run

    logger = get_logger(os.path.join(args.out_dir, "stringdecomposer.log"), logger_name="SD-TPU")
    logger.info("cmd: %s", sys.argv)
    try:
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
        )
    except InvalidSymbolError as e:
        logger.error("ERROR: %s", e)
        return 255  # reference binary exit(-1) semantics (main.cpp:336)
    logger.info("Thank you for using StringDecomposer!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
