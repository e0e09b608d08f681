"""Raw/final TSV emission and deterministic result assembly; the port's copy
of the JAX package's report.py.

Replaces the reference's SaveBatch stdout protocol (src/main.cpp:272-285) and
the final/alt TSV writers of the Python stage (main.py:153-165). Output
ordering is restored host-side by (read order, window offset) exactly as the
reference re-sorts its OpenMP sub-batches (src/main.cpp:103-120), so output
bytes are independent of how many devices/hosts produced the fragments.
"""

from __future__ import annotations

from .ops.oracle import Block


_ID6_MEMO: dict[float, str] = {}
# identities are match/length ratios so a run sees only a few thousand
# distinct doubles — but a long-lived --serve process crossing many unrelated
# jobs must not grow this without bound; reset (cheap, it refills in one
# chunk) past a cap no real assembly reaches
_ID6_MEMO_CAP = 1 << 18


def format_raw_rows(read_name: str, blocks: list[Block], monomer_names: list[str],
                    prev_end: int = 0) -> list[str]:
    """7-column raw TSV rows for one read (src/main.cpp:272-285).

    identity is printed like C++ std::to_string(float) — six decimals.
    `prev_end` seeds the gap column when a read's blocks are emitted in
    chunks (the streaming pipeline); pass the previous chunk's last end.
    Identities are match/length ratios with few distinct doubles across an
    assembly, so their 6-decimal strings memoize (same trick as the final
    emission, finishing.write_final_rows).
    """
    memo = _ID6_MEMO
    if len(memo) > _ID6_MEMO_CAP:
        memo.clear()
    rows = []
    for b in blocks:
        ident = float(b.identity)
        id6 = memo.get(ident)
        if id6 is None:
            id6 = memo[ident] = f"{ident:.6f}"
        rows.append(
            f"{read_name}\t{monomer_names[b.monomer]}\t{b.start}\t{b.end}\t"
            f"{id6}\t{b.start - prev_end}\t{b.end - b.start}"
        )
        prev_end = b.end
    return rows


def write_raw_tsv(path: str, per_read: list[tuple[str, list[Block]]], monomer_names: list[str]) -> None:
    with open(path, "w") as f:
        for read_name, blocks in per_read:
            for row in format_raw_rows(read_name, blocks, monomer_names):
                f.write(row + "\n")


def parse_raw_tsv(text: str) -> list[tuple[str, list[dict]]]:
    """Parse the raw decomposition back, grouping rows by read, keeping only
    the first four columns like the reference finishing stage (main.py:173-182).
    """
    per_read: list[tuple[str, list[dict]]] = []
    cur: list[dict] = []
    prev = None
    for ln in text.split("\n")[:-1]:
        read, monomer, start, end = ln.split("\t")[:4]
        read = read.split()[0]
        monomer = monomer.split()[0]
        if read != prev and prev is not None:
            per_read.append((prev, cur))
            cur = []
        prev = read
        cur.append({"m": monomer, "start": int(start), "end": int(end)})
    if cur:
        per_read.append((prev, cur))
    return per_read
