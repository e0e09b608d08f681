"""FASTA input/output and nucleotide encoding; the port's copy of the JAX
package's io/fasta.py.

Replacement for the reference's two FASTA loaders
(reference: src/main.cpp:314-346 `load_fasta` and main.py:63-72 `load_fasta`).
One loader serves both roles; sequences are validated against the ACGTN
alphabet with the same error semantics as the reference binary
(src/main.cpp:330-344: hard error on non-ACGTN, warning on N).

Nucleotides are encoded to small integers for the device kernels:
A=0, C=1, G=2, T=3, N=4; PAD=5 is used only for device-side padding and
never matches any read symbol.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger("SD-TPU")

# Encoding table: A=0 C=1 G=2 T=3 N=4, PAD=5.
PAD_CODE = 5
_ENC = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate("ACGTN"):
    _ENC[ord(_c)] = _i

_RC = {"A": "T", "T": "A", "G": "C", "C": "G", "N": "N"}

# RC in code space: A<->T (0<->3), C<->G (1<->2), N->N (4), PAD->PAD (5)
RC_CODE = np.array([3, 2, 1, 0, 4, 5], dtype=np.int8)


@dataclass
class Record:
    """A named sequence. `name` is the first whitespace-delimited header token
    (reference: src/main.cpp:321-325 splits the header and keeps token 0;
    Bio.SeqRecord.name behaves the same for the Python stage)."""

    name: str
    seq: str

    def __len__(self) -> int:
        return len(self.seq)


def parse_fasta(text: str) -> list[Record]:
    records: list[Record] = []
    parts: list[str] = []
    name = None
    for line in text.splitlines():
        if line.startswith(">"):
            if name is not None:
                records.append(Record(name, "".join(parts)))
            name = (line[1:].split() or [""])[0]
            parts = []
        elif name is not None:
            parts.append(line.strip())
    if name is not None:
        records.append(Record(name, "".join(parts)))
    return records


def load_fasta(path: str, upper: bool = False) -> list[Record]:
    """Load a FASTA file (plain or gzip — an extension over the reference).

    upper=False mirrors the reference binary (src/main.cpp:314-329 appends
    raw lines, so lowercase input is a validation error); upper=True mirrors
    the reference Python stage (main.py:63-72 calls .upper()).
    """
    if str(path).endswith(".gz"):
        import gzip

        with gzip.open(path, "rt") as f:
            records = parse_fasta(f.read())
    else:
        with open(path) as f:
            records = parse_fasta(f.read())
    if upper:
        for r in records:
            r.seq = r.seq.upper()
    return records


def iter_fasta(path: str, upper: bool = False):
    """Lazily yield Records from a (plain or gzip) FASTA file — bounded
    memory for flowcell-scale read sets (the pipeline's --stream-reads)."""
    if str(path).endswith(".gz"):
        import gzip

        fh = gzip.open(path, "rt")
    else:
        fh = open(path)
    try:
        name = None
        parts: list[str] = []
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seq = "".join(parts)
                    yield Record(name, seq.upper() if upper else seq)
                name = (line[1:].split() or [""])[0]
                parts = []
            elif name is not None:
                parts.append(line.strip())
        if name is not None:
            seq = "".join(parts)
            yield Record(name, seq.upper() if upper else seq)
    finally:
        fh.close()


class InvalidSymbolError(ValueError):
    pass


def validate_acgtn(records: list[Record], filename: str = "") -> None:
    """Reject non-ACGTN symbols, warn once on N (src/main.cpp:330-344)."""
    has_n = False
    for r in records:
        arr = np.frombuffer(r.seq.encode("ascii", errors="replace"), dtype=np.uint8)
        codes = _ENC[arr]
        if (codes < 0).any():
            bad = r.seq[int(np.argmax(codes < 0))]
            raise InvalidSymbolError(
                f"Sequence {r.name} contains undefined symbol (not ACGT): {bad}"
            )
        if (codes == 4).any():
            has_n = True
    if has_n:
        logger.warning(
            "sequences in %s contain N symbol. It will be counted as a "
            "separate symbol in scoring!", filename,
        )


def encode(seq: str) -> np.ndarray:
    """Encode an ACGTN string to int8 codes."""
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    codes = _ENC[arr]
    if (codes < 0).any():
        bad = seq[int(np.argmax(codes < 0))]
        raise InvalidSymbolError(f"undefined symbol (not ACGTN): {bad}")
    return codes


def decode(codes: np.ndarray) -> str:
    return "".join("ACGTN"[c] for c in codes if c != PAD_CODE)


def reverse_complement(seq: str) -> str:
    try:
        return "".join(_RC[c] for c in reversed(seq))
    except KeyError as e:
        raise InvalidSymbolError(f"cannot reverse-complement symbol {e}") from e


def add_reverse_complement(monomers: list[Record]) -> list[Record]:
    """Append RC monomers AFTER all forward ones, names suffixed with "'"
    (reference binary order, src/main.cpp:364-371). This ordering is
    tie-breaking-relevant in the chain DP argmax."""
    return monomers + [Record(m.name + "'", reverse_complement(m.seq)) for m in monomers]


def add_rc_interleaved(monomers: list[Record]) -> list[Record]:
    """Interleave RC right after each forward monomer (reference Python stage
    order, main.py:79-84). This ordering is tie-breaking-relevant in the
    second-best / homopolymer sorts of the rescoring stage."""
    out: list[Record] = []
    for m in monomers:
        out.append(m)
        out.append(Record(m.name + "'", reverse_complement(m.seq)))
    return out


def pad_monomers(monomers: list[Record], pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Encode + right-pad monomers into an [M, L] int8 tensor with PAD_CODE.

    Returns (codes[M, L], lengths[M]). The monomer tensor is tiny (KBs).
    """
    lens = np.array([len(m.seq) for m in monomers], dtype=np.int32)
    L = int(pad_to if pad_to is not None else lens.max())
    if (lens > L).any():
        raise ValueError(f"monomer longer than pad_to={L}")
    codes = np.full((len(monomers), L), PAD_CODE, dtype=np.int8)
    for j, m in enumerate(monomers):
        codes[j, : len(m.seq)] = encode(m.seq)
    return codes, lens


def write_fasta(path: str, records: list[Record]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(f">{r.name}\n{r.seq}\n")
