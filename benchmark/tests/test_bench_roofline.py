"""K1's and K2's counts on shapes worked by hand."""

import numpy as np
from harness import roofline


def test_k1_counts_real_positions_times_real_rows():
    w = roofline.k1_job([5500, 5500, 1200], [192, 171, 171, 170])
    assert w["ops"] == 15 * (5500 + 5500 + 1200) * (192 + 171 + 171 + 170)
    # windows' bases, each row's padded codes and length, each window's count
    assert w["bytes"] == 12_200 + 4 * (192 + 4) + 4 * 3


def test_homo_prefix_counts_runs():
    codes = np.array([0, 0, 1, 1, 1, 2], dtype=np.int8)
    p = roofline.homo_prefix(codes)
    assert p.tolist() == [0, 0, 1, 1, 1, 2]
    hlen = lambda s, n: 1 + p[s + n - 1] - p[s]  # noqa: E731
    assert (hlen(0, 6), hlen(1, 3), hlen(2, 3), hlen(5, 1)) == (3, 2, 1, 1)


def test_k2_packed_counts_both_variants():
    p = roofline.homo_prefix(np.array([0, 0, 1, 1, 1, 2], dtype=np.int8))
    w = roofline.k2_packed(np.array([0, 2]), np.array([6, 3]), p, raw_sum=100, homo_sum=80,
                           M=4, mono_bytes=196)
    assert w["ops"] == 11 * ((6 + 3) * 100 + (3 + 1) * 80)
    assert w["bytes"] == (9 + 4) + 196 + 2 * 2 * 4 * 2 * 4


def test_k2_pairs_and_bound():
    w = roofline.k2_pairs(cells=171 * 170 * 10, q_bases=1710, t_bases=1700, pairs=10)
    assert w["ops"] == 11 * 171 * 170 * 10
    assert roofline.bound_s(0, roofline.INT32_OPS_PER_S) == 1.0
    assert roofline.bound_s(roofline.HBM_BYTES_PER_S * 2, 1) == 2.0
