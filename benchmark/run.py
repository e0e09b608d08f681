"""The benchmark of stringdecomposer_tpu_torch: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown` and
`card`, and last `check`, each number compared beside its limit; the same
numbers end standard error. Exits non-zero, printing no result, without a
CUDA device, when the program cannot be imported, or when the process
has loaded jax, jaxlib, flax or the JAX package.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of a build or compile lives in the checkout, at a fixed path
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(HERE / "_cache" / sub)
os.environ["USE_FLAX"] = "0"
# one thread in each CPU pool: client threads, not idle pool threads spinning
# between parallel regions, share the host's cores (steadier runs)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(ROOT), str(HERE)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from harness import session, spec

    cell = spec.cell(spec.benchmark(), a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    result, numbers = session.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), T_PROCESS,
                                       log=log)
    bad = session.loaded_forbidden()
    if bad:
        log(f"the process loaded {', '.join(bad)}: the port's run may load none of them")
        return 3
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    for n, v, lim in numbers:
        log(f"{n} {v} limit {lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
