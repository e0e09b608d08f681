"""The benchmark's seeded centromere array: tandem copies of a higher-order
repeat (HOR), the monomers joined in file order, each copy a little
diverged from the unit.

The 12 DXZ1 monomers of StringDecomposer's test data are in the HOR's
order (their names carry their spans in the doubled unit), so the unit is
the 2,054 bp DXZ1 HOR, as in stringdecomposer_tpu_torch/scripts/
workloads.py `hor_unit` at commit 5ef96e3.
"""

from __future__ import annotations


def hor_unit(monomers: list[tuple[str, str]]) -> str:
    """The monomers joined in file order."""
    return "".join(s for _, s in monomers)


def hor_array(n_bp: int, monomers: list[tuple[str, str]], divergence: tuple[float, float],
              rng) -> str:
    """n_bp of tandem HOR copies: copy c carries round(len(unit) * d_c)
    random edits (substitution p 0.6, deletion 0.2, insertion 0.2), d_c
    drawn uniformly from `divergence`."""
    unit = hor_unit(monomers)
    lo, hi = divergence
    out = []
    total = 0
    while total < n_bp:
        u = list(unit)
        for _ in range(int(round(len(unit) * rng.uniform(lo, hi)))):
            p = int(rng.integers(len(u)))
            r = rng.random()
            if r < 0.6:
                u[p] = "ACGT".replace(u[p], "")[int(rng.integers(3))]
            elif r < 0.8:
                del u[p]
            else:
                u.insert(p, "ACGT"[int(rng.integers(4))])
        s = "".join(u)
        out.append(s)
        total += len(s)
    return "".join(out)[:n_bp]
