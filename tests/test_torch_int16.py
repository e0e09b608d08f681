"""K1's int16 state in the PyTorch port, and P, its probe.

The port's int16 twin (ops/chain_dp.chain_dp_forward(state_dtype="int16"),
and the K1 wrappers' CPU dispatch) against its int32 twin and against the
JAX package's chain_dp_forward_pallas(state_dtype="int16") run interpreted,
on the fixtures of test_pallas_kernel.py:16-97. Every output is an integer
array and must be equal (tolerance 0). Also the refusals: an unsafe range
and a failed probe each raise a ValueError that says so, and P's plain
version against the JAX probe's body run through pl.pallas_call
interpreted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stringdecomposer_tpu.io.fasta import Record, add_reverse_complement, encode, pad_monomers
from stringdecomposer_tpu.ops.chain_dp import build_window_batch
from stringdecomposer_tpu.ops.chain_dp_pallas import _check_int16_bounds, chain_dp_forward_pallas
from stringdecomposer_tpu_torch.ops import chain_dp as plain
from stringdecomposer_tpu_torch.ops import chain_dp_cuda

torch.set_num_threads(1)


def _case(random_cases, idx, lens_list=(60, 37, 64)):
    """test_pallas_kernel.py's windows: prefixes of a fixture read, W = 64."""
    case = random_cases[idx]
    monomers = add_reverse_complement([Record(n, s) for n, s in case["monomers"]])
    mono, lens = pad_monomers(
        monomers, pad_to=(max(len(m.seq) for m in monomers) + 7) // 8 * 8)
    seq = case.get("read") or case["reads"][1][1]
    wb, wl = build_window_batch([encode(seq[:n]) for n in lens_list], 64)
    return wb, wl, mono, lens, case["scoring"]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _scoring(sc):
    return dict(ins=sc[0], dele=sc[1], mismatch=sc[2], match=sc[3])


@pytest.mark.parametrize("idx", range(4))
def test_int16_twin_matches_int32_and_jax_interpreted(random_cases, idx):
    """test_pallas_kernel.py:16-33 (shared monomers, block_windows 2)."""
    wb, wl, mono, lens, sc = _case(random_cases, idx)
    kw = _scoring(sc)
    jb, jc = chain_dp_forward_pallas(wb, wl, mono, lens, block_windows=2, pos_tile=16,
                                     state_dtype="int16", **kw)
    b16, c16 = plain.chain_dp_forward(*_t(wb, wl, mono, lens), state_dtype="int16", **kw)
    b32, c32 = plain.chain_dp_forward(*_t(wb, wl, mono, lens), state_dtype="int32", **kw)
    np.testing.assert_array_equal(b16.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(c16.numpy(), np.asarray(jc))
    assert torch.equal(b16, b32) and torch.equal(c16, c32)


def test_int16_per_window_monomers(random_cases):
    """test_pallas_kernel.py:36-58: a different monomer subset per window."""
    wb, wl, mono, lens, _ = _case(random_cases, 0)
    B, M, L = wb.shape[0], mono.shape[0], mono.shape[1]
    rng = np.random.default_rng(0)
    mono_b = np.full((B, M, L), 5, dtype=np.int8)
    lens_b = np.zeros((B, M), dtype=np.int32)
    for b in range(B):
        keep = rng.permutation(M)[: M - b]
        mono_b[b, : len(keep)] = mono[keep]
        lens_b[b, : len(keep)] = lens[keep]
    jb, jc = chain_dp_forward_pallas(wb, wl, mono_b, lens_b, block_windows=2, pos_tile=16,
                                     state_dtype="int16")
    for fn in (plain.chain_dp_forward, chain_dp_cuda.chain_dp_forward_cuda,
               chain_dp_cuda.chain_dp_large_cuda):
        b16, c16 = fn(*_t(wb, wl, mono_b, lens_b), state_dtype="int16")
        np.testing.assert_array_equal(b16.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(c16.numpy(), np.asarray(jc))


def test_int16_debug_arrays(random_cases):
    """return_debug gives int32 arrays either way: end and spend equal on
    real rows, rows of length 0 carry the int16 sentinel -2^13 (JAX's
    cast, chain_dp_pallas.py:508-513), and the chain is the int32 one."""
    wb, wl, mono, lens, sc = _case(random_cases, 1)
    lens = lens.copy()
    lens[-2:] = 0
    kw = dict(_scoring(sc), return_debug=True)
    _, _, (ch16, e16, s16) = plain.chain_dp_forward(*_t(wb, wl, mono, lens), state_dtype="int16",
                                                    **kw)
    _, _, (ch32, e32, s32) = plain.chain_dp_forward(*_t(wb, wl, mono, lens), **kw)
    assert e16.dtype == s16.dtype == ch16.dtype == torch.int32
    real = torch.from_numpy(lens > 0)
    assert torch.equal(e16[:, :, real], e32[:, :, real])
    assert torch.equal(s16[:, :, real], s32[:, :, real])
    assert (e16[:, :, ~real] == plain.NEG16).all() and (e32[:, :, ~real] == plain.NEG).all()
    assert torch.equal(ch16, ch32)


@pytest.mark.parametrize("fn", ["chain_dp_forward_cuda", "chain_dp_large_cuda"])
def test_wrappers_cpu_dispatch_int16(random_cases, fn):
    """The K1 wrappers run the int16 twin on CPU tensors and launch nothing;
    "auto" is int32."""
    wb, wl, mono, lens, sc = _case(random_cases, 2)
    wrapper = getattr(chain_dp_cuda, fn)
    before = (wrapper.launches, wrapper.launches_int16, chain_dp_cuda.int16_probe_cuda.launches)
    kw = dict(_scoring(sc), return_debug=True)
    got = wrapper(*_t(wb, wl, mono, lens), state_dtype="int16", **kw)
    want = plain.chain_dp_forward(*_t(wb, wl, mono, lens), state_dtype="int16", **kw)
    auto = wrapper(*_t(wb, wl, mono, lens), **kw)
    i32 = plain.chain_dp_forward(*_t(wb, wl, mono, lens), state_dtype="int32", **kw)
    for g, w in zip(got[:2] + got[2], want[:2] + want[2]):
        assert torch.equal(g, w)
    for a, w in zip(auto[:2] + auto[2], i32[:2] + i32[2]):
        assert torch.equal(a, w)
    assert (wrapper.launches, wrapper.launches_int16,
            chain_dp_cuda.int16_probe_cuda.launches) == before


def test_int16_large_library_matches_int32():
    """M = 128 (the size test_pallas_kernel.py:100 uses) with rows of length
    0, over windows of 96: the int16 twin equals the int32 twin."""
    rng = np.random.default_rng(23)
    alpha = np.array(list("ACGT"))
    fwd = [Record(f"m{j}", "".join(rng.choice(alpha, int(rng.integers(20, 40)))))
           for j in range(64)]
    monomers = add_reverse_complement(fwd)
    mono, lens = pad_monomers(monomers, pad_to=40)
    lens[-3:] = 0
    wins = []
    for _ in range(3):
        unit = fwd[int(rng.integers(64))].seq
        arr = np.array(list((unit * 6)[: int(rng.integers(50, 96))]))
        idx = rng.integers(0, len(arr), max(1, len(arr) // 10))
        arr[idx] = rng.choice(alpha, len(idx))
        wins.append(encode("".join(arr)))
    wb, wl = build_window_batch(wins, 96)
    a = plain.chain_dp_forward(*_t(wb, wl, mono, lens), state_dtype="int16")
    b = plain.chain_dp_forward(*_t(wb, wl, mono, lens))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[1].min()) >= 1


@pytest.mark.parametrize("W,L,sc", [(64, 24, (-1000, -1000, -1000, 1000)),
                                    (24_000, 192, (-1, -1, -1, 1)),
                                    (8_000, 192, (-3, -3, -3, 3)),
                                    (64, 24, (-1, -1, -1, 1))])
def test_unsafe_range_is_refused_like_jax(W, L, sc):
    """The same bound as chain_dp_pallas._check_int16_bounds on the same W
    and L, and the same "unsafe" ValueError, raised before any work by the
    twin and by both wrappers. The port refuses more: W = 24,000 passes
    JAX's check but not int16_sentinel_ok (see the next test)."""
    assert plain.int16_bounds_ok(W, L, *sc) == _check_int16_bounds(W, L, *sc)
    args = _t(np.full((1, W), 6, np.int8), np.array([1], np.int32),
              np.zeros((2, L), np.int8), np.array([L, 1], np.int32))
    fns = (plain.chain_dp_forward, chain_dp_cuda.chain_dp_forward_cuda,
           chain_dp_cuda.chain_dp_large_cuda)
    if plain.int16_sentinel_ok(W, L, *sc):
        assert _check_int16_bounds(W, L, *sc)
        plain.resolve_state_dtype("int16", W, L, *sc)  # nothing raises
        return
    for fn in fns:
        with pytest.raises(ValueError, match="unsafe"):
            fn(*args, state_dtype="int16", **_scoring(sc))


@pytest.mark.parametrize("W,L,sc", [(100, 4, (-100, -100, -100, 100)),
                                    (8_000, 192, (-1, -1, -1, 1)),
                                    (24_000, 192, (-1, -1, -1, 1))])
def test_int16_sentinel_range_is_refused(W, L, sc):
    """Windows that JAX's range check admits but where a real score can
    fall below the int16 sentinel -2^13: the port refuses them with the
    "unsafe" ValueError. At the first, small shape the reason shows: on a
    window that matches nothing the chain score falls by one unit a
    position, and the int16 sweep, run past the check, stores -2^13 where
    the int32 sweep stores the score."""
    assert _check_int16_bounds(W, L, *sc) and not plain.int16_sentinel_ok(W, L, *sc)
    with pytest.raises(ValueError, match="sentinel"):
        plain.resolve_state_dtype("int16", W, L, *sc)
    if W > 100:
        return
    windows = torch.full((1, W), 6, dtype=torch.int8)  # never equals a monomer code
    mono = torch.zeros((1, 1, L), dtype=torch.int8)
    lens = torch.full((1, 1), L, dtype=torch.int32)
    kw = _scoring(sc)
    ends = {}
    for dt in (torch.int16, torch.int32):
        dp0 = plain.init_column(windows, mono, lens, sc[1], sc[2], sc[3], dt)
        ends[dt] = plain.sweep(windows, mono, lens, dp0, **kw)[1].to(torch.int32)
    assert int(ends[torch.int32].min()) < plain.NEG16
    assert int(ends[torch.int16].min()) == plain.NEG16
    assert not torch.equal(ends[torch.int16], ends[torch.int32])


def test_unknown_state_dtype_is_refused():
    with pytest.raises(ValueError, match="state_dtype"):
        plain.resolve_state_dtype("int8", 64, 24, -1, -1, -1, 1)
    assert plain.resolve_state_dtype("auto", 10**6, 192, -1, -1, -1, 1) == torch.int32


def test_probe_failure_raises_chained_value_error(random_cases, monkeypatch):
    """A probe that fails to build or launch is never a quiet int32 run: the
    int16 request raises a ValueError that says the probe failed, chained
    from the error."""
    wb, wl, mono, lens, sc = _case(random_cases, 0)
    cause = RuntimeError("int16 probe kernel: CUDA error 209 (no kernel image)")

    def broken(device):
        raise cause

    monkeypatch.setattr(chain_dp_cuda, "int16_state_supported", broken)
    for fn in (chain_dp_cuda.chain_dp_forward_cuda, chain_dp_cuda.chain_dp_large_cuda):
        with pytest.raises(ValueError, match="probe kernel failed") as info:
            fn(*_t(wb, wl, mono, lens), state_dtype="int16", **_scoring(sc))
        assert info.value.__cause__ is cause
    # int32 and auto never consult the probe
    chain_dp_cuda.chain_dp_forward_cuda(*_t(wb, wl, mono, lens), **_scoring(sc))
    monkeypatch.setattr(chain_dp_cuda, "int16_state_supported", lambda device: False)
    with pytest.raises(ValueError, match="disagrees"):
        chain_dp_cuda.chain_dp_forward_cuda(*_t(wb, wl, mono, lens), state_dtype="int16")


def test_probe_on_cpu_launches_nothing():
    before = chain_dp_cuda.int16_probe_cuda.launches
    assert chain_dp_cuda.int16_state_supported("cpu") is True
    assert chain_dp_cuda.int16_probe_cuda.launches == before


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_plain_matches_pallas_probe_interpreted(seed):
    """P's plain version against the body of the JAX probe
    (chain_dp_pallas.py:106-108) run through pl.pallas_call(interpret=True)
    on [8, 256] int16 data; the wrapper's CPU dispatch gives the same."""

    def k(x_ref, o_ref):
        v = x_ref[...]
        o_ref[...] = jnp.maximum(pltpu.roll(v, 1, 1), v)

    rng = np.random.default_rng(seed)
    v = rng.integers(-(1 << 15), 1 << 15, (8, 256), dtype=np.int16)
    want = np.asarray(pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((8, 256), jnp.int16), interpret=True)(jnp.asarray(v)))
    got = chain_dp_cuda.int16_probe_plain(torch.from_numpy(v))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(chain_dp_cuda.int16_probe_cuda(torch.from_numpy(v)).numpy(),
                                  want)
    # lane c takes lane c - 1 mod 256
    np.testing.assert_array_equal(want[:, 0], np.maximum(v[:, -1], v[:, 0]))


def test_int16_route_limits():
    """int16 halves the column's shared memory (9 -> 5 bytes a cell): at
    L = 192 the shared route takes M <= 240 in int16, M <= 133 in int32."""
    assert chain_dp_cuda.smem_bytes(24, 192) == (2 * 24 * 192 + 2 * 24) * 4 + 24 * 192
    assert chain_dp_cuda.smem_bytes(24, 192, 2) == 5 * 24 * 192 + 8 * 24
    assert chain_dp_cuda.route(133, 192) == "shared" and chain_dp_cuda.route(134, 192) == "large"
    assert chain_dp_cuda.route(200, 192, 2) == "shared" and chain_dp_cuda.route(200, 192) == "large"
    assert chain_dp_cuda.route(240, 192, 2) == "shared"
    assert chain_dp_cuda.route(241, 192, 2) == "large"
    assert chain_dp_cuda.route(264, 192, 2) == "large"
