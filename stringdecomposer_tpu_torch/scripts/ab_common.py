"""What the A/B scripts beside this file (k1_ab.py, k2_ab.py,
banded_ab.py) share: the import of the checkout under ROOT with its kernels
built, the run's header (the card's name and power limit, the checkout's
ptxas lines), CUDA-event timing and the end-to-end runner with stage spans.
The scripts run as files, so they import this module, and workloads.py,
from beside them, whichever checkout they time. The benches run as modules
(ablate_chain.py, stress_m_scale.py) take the card's header from here."""

from __future__ import annotations

import hashlib
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

DATA = Path(__file__).resolve().parents[1] / "test_data"
ENTRY = re.compile(r"Compiling entry function '_ZN\w*?_cu_\w{8}\d+([a-z_0-9]+)(I\w*?EE)?")


def checkout(root: str, kernels: str | tuple[str, ...], who: str):
    """Imports torch and the `stringdecomposer_tpu_torch` under `root` and
    builds its kernels with its own runtime/build.py. Returns (torch,
    header): the checkout, the card's name and power limit, and the ptxas
    register and spill lines of the entries whose name holds `kernels` (or
    one of them; from its build.log). Exits 2 where no card is seen."""
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    path = Path(root).resolve()
    sys.path.insert(0, str(path))
    import torch

    if not torch.cuda.is_available():
        print(f"{who}: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        sys.exit(2)
    import stringdecomposer_tpu_torch as pkg
    from stringdecomposer_tpu_torch.runtime import build

    if Path(pkg.__file__).resolve().parent != path / "stringdecomposer_tpu_torch":
        raise RuntimeError(f"imported {pkg.__file__}, not the checkout under {path}")
    build.library()
    ptxas, entry = [], "?"
    for ln in (build.library_path().parent / "build.log").read_text().splitlines():
        m = ENTRY.search(ln)
        if m:
            entry = m.group(1) + (m.group(2) or "")
        elif any(k in entry for k in kernels) and ("registers" in ln or "spill" in ln):
            ptxas.append(f"{entry}: {ln.strip()}")
    return torch, {"root": root, "gpu": gpu_header(), "ptxas": ptxas}


def gpu_header() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def ms(torch, fn, reps: int) -> list[float]:
    """One warm-up call of fn, then `reps` calls timed with CUDA events (ms)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1))
    return out


def e2e(torch, runs) -> dict:
    """{name: {"e2e_s": [...], "spans": {stage: s}, "digest": ...}} for each
    (name, reads FASTA, monomers FASTA, reps, pipeline.run keywords) of
    `runs`: the port end to end with --second-best on the card, one warm-up
    run, `reps` runs timed on the host clock up to a synchronize, then one
    run with the stage timer on for its spans. The digest is of that run's
    final TSV, so that the turns can be held equal."""
    from stringdecomposer_tpu_torch import pipeline
    from stringdecomposer_tpu_torch.utils import stagetimer

    out = {}
    for name, reads, monos, reps, kw in runs:
        with tempfile.TemporaryDirectory() as d:
            def one():
                t0 = time.perf_counter()
                pipeline.run(reads, monos, out_dir=d, second_best=True, device="cuda", **kw)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            one()  # warm-up
            secs = [one() for _ in range(reps)]
            stagetimer.enable()
            try:
                one()
                spans = stagetimer.snapshot()
            finally:
                stagetimer.disable()
            digest = hashlib.sha256((Path(d) / "final_decomposition.tsv").read_bytes())
        out[name] = {"e2e_s": secs, "spans": spans, "digest": digest.hexdigest()[:16]}
    return out
