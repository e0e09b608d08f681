"""The reduction of a device trace, on a trace written by hand: device
operations go to the innermost bench.* span open on the launching thread,
busy time is the union within the window, gaps are named by the spans the
host threads were in."""

import json

import pytest

from harness.trace import short_name, summarize


def ev(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_summarize(tmp_path):
    events = [
        ev("user_annotation", "bench.job", 0, 1000, 1),
        ev("user_annotation", "bench.k1", 100, 50, 1),
        ev("user_annotation", "bench.job", 200, 1000, 2),
        ev("user_annotation", "bench.k2", 300, 20, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 110, 5, 1, correlation=1),
        ev("cuda_runtime", "cudaLaunchKernel", 310, 5, 2, correlation=2),
        ev("cuda_runtime", "cudaLaunchKernel", 600, 5, 1, correlation=3),
        ev("kernel", "void (anonymous namespace)::chain_dp_cluster_kernel<int, 6>(int const*)",
           120, 300, 7, correlation=1),
        ev("kernel", "void nw_identity_kernel<7>(int*)", 320, 200, 8, correlation=2),
        ev("gpu_memcpy", "Memcpy DtoH", 900, 100, 7, correlation=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(path))
    assert s.window_s == pytest.approx(1200e-6)
    assert s.span_device_s == pytest.approx({"k1": 300e-6, "k2": 200e-6, "job": 100e-6})
    assert abs(s.busy_s - (400e-6 + 100e-6)) < 1e-12  # [120, 520) and [900, 1000)
    assert abs(s.span_union_s["k1"] - 300e-6) < 1e-12
    assert s.device_ops[0] == ["chain_dp_cluster_kernel<int, 6>", pytest.approx(300e-6)]
    assert s.idle_gaps[0][0] == "job" and abs(s.idle_gaps[0][1] - 380e-6) < 1e-12
    assert [g[0] for g in s.idle_gaps] == ["job", "idle+job", "idle+job"]  # thread 1 done at 1000


def test_short_name():
    assert short_name("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous "
                      "namespace)::f<int>>(int, float)") == \
        "at::native::vectorized_elementwise_kernel<4, at::native::f<int>>"
