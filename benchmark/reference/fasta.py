"""FASTA reading and the nucleotide codes of the plain reference.

Semantics of StringDecomposer (ablab/stringdecomposer): a record's name is
the first word of its header; the DP stage's monomer order is every
forward monomer, then every reverse complement (src/main.cpp:364-371); the
finishing stage's order interleaves each monomer with its reverse
complement (main.py:79-84); a reverse complement is named `<name>'`.
Codes: A=0 C=1 G=2 T=3 N=4; PAD=5 matches nothing.
"""

from __future__ import annotations

import numpy as np

PAD = 5
_ENC = np.full(256, -1, dtype=np.int16)
for _i, _c in enumerate("ACGTN"):
    _ENC[ord(_c)] = _i
_COMPLEMENT = str.maketrans("ACGTN", "TGCAN")


def read_fasta(path: str) -> list[tuple[str, str]]:
    """[(name, sequence)] of a FASTA file, sequences upper-cased."""
    out: list[tuple[str, str]] = []
    name, parts = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(parts).upper()))
                name, parts = (line[1:].split() or [""])[0], []
            elif name is not None:
                parts.append(line.strip())
    if name is not None:
        out.append((name, "".join(parts).upper()))
    return out


def encode(seq: str) -> np.ndarray:
    codes = _ENC[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
    if (codes < 0).any():
        raise ValueError("sequence holds a symbol outside ACGTN")
    return codes.astype(np.int8)


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def dp_order(monomers: list[tuple[str, str]]) -> list[tuple[str, str]]:
    return monomers + [(n + "'", reverse_complement(s)) for n, s in monomers]


def finishing_order(monomers: list[tuple[str, str]]) -> list[tuple[str, str]]:
    out = []
    for n, s in monomers:
        out += [(n, s), (n + "'", reverse_complement(s))]
    return out


def homo_compress(codes: np.ndarray) -> np.ndarray:
    """Homopolymer runs collapsed to one base (main.py:87-92)."""
    if len(codes) == 0:
        return codes
    return codes[np.concatenate(([True], codes[1:] != codes[:-1]))]
