"""The finishing stage of StringDecomposer, plain (main.py:95-165): each
block's identity against its own monomer, and with `--second-best`
against every monomer, raw and homopolymer-compressed; the second best
(first strict improvement over names, main.py:131-135), the homopolymer
ranking (stable sort on -score, main.py:142), the reliability flag (the
logistic model of models/ont_logreg_model.txt, main.py:95-104) and the
final and alt rows ("{:.2f}", main.py:153-165).
"""

from __future__ import annotations

import os

import numpy as np

from .fasta import encode, homo_compress
from .nw_identity import identity, nw_counts

_MODEL = os.path.join(os.path.dirname(__file__), "ont_logreg_model.txt")


def coefficients() -> np.ndarray:
    with open(_MODEL) as f:
        return np.array([float(x) for x in f.readline().split()], dtype=np.float64)


def final_rows(reads: list[tuple[str, str, list[tuple[str, int, int]]]],
               monomers: list[tuple[str, str]], second_best: bool, device,
               prefer: str = "up") -> list[tuple[list[str], list[str]]]:
    """(final rows, alt rows) of each read's `blocks` [(monomer name,
    start, end)], for [(read name, read, blocks)]; `monomers` in the
    finishing order (finishing_order). The NW counts of every read's pairs
    are taken in one call."""
    names = [n for n, _ in monomers]
    idx = {n: i for i, n in enumerate(names)}  # a repeated name: its last row
    codes = [encode(s) for _, s in monomers]
    homo = [homo_compress(c) for c in codes]
    segs = []
    for _, read, blocks in reads:
        rcodes = encode(read)
        segs += [rcodes[s : e + 1] for _, s, e in blocks]
    coef = coefficients()
    fmt = "{:.2f}".format
    out = []
    if not second_best:
        mt, ln = nw_counts(segs, [codes[idx[m]] for _, _, blocks in reads for m, _, _ in blocks],
                           device, prefer)
        score = identity(mt, ln)
        b0 = 0
        for read_name, _, blocks in reads:
            rows = []
            for (m, s, e), sc in zip(blocks, score[b0 : b0 + len(blocks)]):
                ok = coef[0] + sc * coef[1] + (sc + 1.0) * coef[2] > 0
                rows.append(f"{read_name}\t{m}\t{s}\t{e}\t{fmt(sc)}\tNone\t-1.00\tNone\t-1.00"
                            f"\tNone\t-1.00\t{'+' if ok else '?'}\n")
            out.append((rows, []))
            b0 += len(blocks)
        return out
    M = len(names)
    nb = len(segs)
    qs = [x for x in segs for _ in range(M)]
    mt, ln = nw_counts(qs, codes * nb, device, prefer)
    sc = identity(mt, ln).reshape(nb, M)
    hq = [homo_compress(x) for x in segs]
    mt, ln = nw_counts([x for x in hq for _ in range(M)], homo * nb, device, prefer)
    hsc = identity(mt, ln).reshape(nb, M)
    uniq = list(dict.fromkeys(names))  # first-occurrence order, last occurrence's score
    last = [max(i for i, n in enumerate(names) if n == u) for u in uniq]
    b = 0
    for read_name, _, blocks in reads:
        rows, alt_rows = [], []
        for m, s, e in blocks:
            best = sc[b, idx[m]]
            alt = {u: sc[b, j] for u, j in zip(uniq, last)}
            sb_name, sb = "None", -1.0
            for u in uniq:  # first strict improvement wins
                if u != m and (sb_name == "None" or alt[u] > sb):
                    sb_name, sb = u, alt[u]
            order = sorted(range(M), key=lambda j: -hsc[b, j])  # stable
            hb_name, hb = names[order[0]], hsc[b, order[0]]
            hs_name, hs = (names[order[1]], hsc[b, order[1]]) if M > 1 else ("None", -1.0)
            ok = coef[0] + best * coef[1] + (best - sb) * coef[2] > 0
            rows.append(f"{read_name}\t{m}\t{s}\t{e}\t{fmt(best)}\t{sb_name}\t{fmt(sb)}"
                        f"\t{hb_name}\t{fmt(hb)}\t{hs_name}\t{fmt(hs)}\t{'+' if ok else '?'}\n")
            for u in uniq:
                alt_rows.append(f"{read_name}\t{u}\t{s}\t{e}\t{fmt(alt[u])}"
                                f"\t{'*' if u == m else '-'}\n")
            b += 1
        out.append((rows, alt_rows))
    return out
