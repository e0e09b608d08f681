"""The one generator of the benchmark's inputs: a configuration and a
traffic mix (their JSON files) and the seed give the monomer FASTA, each
client's array and warm-up job, and which jobs' outputs are kept for the
check. Everything is drawn from numpy.random.default_rng([seed, stream]);
each seed gets an array of the same size and law, on other sequence.

Traffic keys:
  loop      "closed": `clients` threads each run jobs back to back
  clients   the number of client threads
  job       {"kind": "array"}: the configuration's array, one per client
  warm_bp   each client warms on its array's first warm_bp
  check     {"jobs": n, "windows": w, "keep_every": k}: outputs of every
            k-th job are kept; after the window n of them are judged over
            regions of w windows whose middles cover every slot of a
            device batch (harness/check.py)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .spec import ROOT
from .workloads import hor_array

# rng streams
ARRAY, SAMPLE = 1, 200


@dataclass
class Input:
    """One FASTA of one sequence, as a job hands it to run()."""
    fasta: str
    name: str
    seq: str = field(repr=False)

    @property
    def bp(self) -> int:
        return len(self.seq)


@dataclass
class Inputs:
    monomers_fa: str
    monomers: list  # [(name, seq)] forward, as written to monomers_fa
    jobs: list  # [client] -> Input
    warm: list  # [client] -> [Input]
    phase: list  # [client] -> the kept jobs' index modulo keep_every


def rng(seed: int, stream: int, sub: int = 0):
    return np.random.default_rng([seed % (1 << 64), stream, sub])


def read_fasta(path: str) -> list[tuple[str, str]]:
    out, name, parts = [], None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(parts)))
                name, parts = (line[1:].split() or [""])[0], []
            elif name is not None:
                parts.append(line.strip())
    if name is not None:
        out.append((name, "".join(parts)))
    return out


def write_fasta(path: str, records: list[tuple[str, str]]) -> str:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")
    return path


def _input(run_dir: str, name: str, seq: str) -> Input:
    return Input(write_fasta(os.path.join(run_dir, f"{name}.fa"), [(name, seq)]), name, seq)


def make(config: dict, traffic: dict, seed: int, run_dir: str) -> Inputs:
    if traffic["loop"] != "closed" or traffic["job"]["kind"] != "array":
        raise ValueError(f"the harness runs closed loops of arrays, not {traffic['loop']!r} "
                         f"loops of {traffic['job']['kind']!r}")
    monomers = read_fasta(str(ROOT / config["monomers"]["file"]))
    mono_fa = write_fasta(os.path.join(run_dir, "monomers.fa"), monomers)
    array = config["array"]
    clients = traffic["clients"]
    jobs, warm = [], []
    for c in range(clients):
        seq = hor_array(array["bp"], monomers, tuple(array["divergence"]), rng(seed, ARRAY, c))
        jobs.append(_input(run_dir, f"array_c{c}", seq))
        warm.append([_input(run_dir, f"warm_c{c}", seq[: traffic["warm_bp"]])])
    keep = traffic["check"]["keep_every"]
    phase = [int(x) for x in rng(seed, SAMPLE).integers(keep, size=clients)]
    return Inputs(mono_fa, monomers, jobs, warm, phase)
