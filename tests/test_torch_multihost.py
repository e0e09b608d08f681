"""The port's multi-host runs (stringdecomposer_tpu_torch/parallel/multihost.py)
on the CPU: every case of tests/test_multihost.py, run by the port's
run_multihost(device="cpu") and by the JAX package's run_multihost on the
same inputs. Fragments, sidecars, sentinels and merged TSVs must be equal
byte for byte, and the merged TSVs equal to a one-process run."""

import filecmp
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

from stringdecomposer_tpu.parallel import multihost as j_mh
from stringdecomposer_tpu_torch import pipeline
from stringdecomposer_tpu_torch.parallel import mesh
from stringdecomposer_tpu_torch.parallel import multihost as mh
from stringdecomposer_tpu_torch.parallel.multihost import HostTopology

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ENV = {**os.environ, "PYTHONPATH": str(REPO)}
TSVS = ("final_decomposition_raw.tsv", "final_decomposition.tsv", "final_decomposition_alt.tsv")
COMMON = dict(batch_size=16, overlap=4, device_batch=2, second_best=True)
CLI_FLAGS = ["-b", "16", "-v", "4", "--device-batch", "2", "--second-best"]


def run_multihost(*args, **kw):
    return mh.run_multihost(*args, device="cpu", **kw)


def run_single(*args, **kw):
    return pipeline.run(*args, device="cpu", **kw)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _read(p):
    with open(p) as f:
        return f.read()


@pytest.fixture
def case(tmp_path):
    seqs = tmp_path / "seqs.fa"
    mono = tmp_path / "monomers.fa"
    _write(
        seqs,
        ">r1\nACGTACGGACGTACGTTACGTACGT\n"
        ">r2\nTTTTACGTACGT\n"
        ">r3\nACGTACGTACGAACGTTTTTTT\n",
    )
    _write(mono, ">mA\nACGTACGT\n>mB\nTTTT\n")
    return str(seqs), str(mono), tmp_path


def _outputs(d) -> dict:
    """Every file a run leaves in `d` (fragments, sidecars, sentinels,
    merged TSVs) but its log."""
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(d).iterdir())
            if p.is_file() and p.name != "stringdecomposer.log"}


def _same_as_jax(port_dir, jax_dir):
    got, want = _outputs(port_dir), _outputs(jax_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert any(n.endswith(".done") for n in got)


def _same_as_single(multi, single, names=TSVS):
    for name in names:
        assert _read(multi / name) == _read(single / name), name


def _both_hosts(seqs, mono, out, runner, hosts=2, order=(1, 0), **kw):
    for h in order:
        res = runner(seqs, mono, out_dir=str(out), topology=HostTopology(hosts, h), **COMMON,
                     **kw)
        assert (res is None) == (h != 0)


def test_two_hosts_byte_identical(case):
    seqs, mono, tmp = case
    run_single(seqs, mono, out_dir=str(tmp / "single"), **COMMON)
    _both_hosts(seqs, mono, tmp / "multi", run_multihost)
    _both_hosts(seqs, mono, tmp / "jax", j_mh.run_multihost)
    _same_as_single(tmp / "multi", tmp / "single")
    _same_as_jax(tmp / "multi", tmp / "jax")


def test_resume_skips_dp(case):
    seqs, mono, tmp = case
    out, jout = tmp / "resume", tmp / "jax"
    _both_hosts(seqs, mono, out, run_multihost)
    frag = out / "final_decomposition_raw.shard00001.tsv"
    before = os.path.getmtime(frag)
    final = _read(out / "final_decomposition.tsv")
    _both_hosts(seqs, mono, out, run_multihost, resume=True)
    assert os.path.getmtime(frag) == before  # DP stage skipped
    assert _read(out / "final_decomposition.tsv") == final

    # changed inputs must invalidate the checkpoint despite --resume
    with open(seqs, "a") as f:
        f.write(">r4\nACGTACGTACGT\n")
    _both_hosts(seqs, mono, out, run_multihost, resume=True)
    assert os.path.getmtime(frag) != before  # fingerprint mismatch -> recompute
    rows = _read(out / "final_decomposition.tsv").splitlines()
    assert any(r.startswith("r4\t") for r in rows)
    _both_hosts(seqs, mono, jout, j_mh.run_multihost)
    _same_as_jax(out, jout)


def test_dead_host_detected(tmp_path):
    """A host with no sentinel and a stale (or absent) heartbeat fails the
    merge wait fast, naming the dead host, not after the full timeout."""
    frag = mh.fragment_path(str(tmp_path), "final_decomposition", 1)
    assert frag == j_mh.fragment_path(str(tmp_path), "final_decomposition", 1)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"host\(s\) 1 appear dead"):
        mh._wait_for([frag + ".done"], "fp", timeout=60.0, poll=0.05, liveness_grace=0.3)
    assert time.monotonic() - t0 < 30.0  # failed fast, not at timeout


def test_live_heartbeat_keeps_wait_alive(tmp_path):
    """A fresh heartbeat suppresses dead-host declaration until the sentinel
    (with the CURRENT fingerprint) lands; a stale-fingerprint sentinel is
    never accepted."""
    frag = mh.fragment_path(str(tmp_path), "final_decomposition", 0)
    with open(frag + ".done", "w") as f:
        f.write("other-fingerprint\n")

    def worker():
        with mh._HeartbeatThread(frag, period=0.05):
            time.sleep(0.8)  # longer than liveness_grace: only heartbeat saves us
            with open(frag + ".done", "w") as f:
                f.write("fp\n")

    t = threading.Thread(target=worker)
    t.start()
    try:
        mh._wait_for([frag + ".done"], "fp", timeout=30.0, poll=0.05, liveness_grace=0.4)
    finally:
        t.join(timeout=30)
    assert not t.is_alive()
    assert not os.path.exists(mh._heartbeat(frag))  # removed when the thread stops


def test_rerun_with_changed_inputs_no_stale_merge(case):
    """Re-running (without --resume) into an out_dir holding a previous run's
    fragments must recompute and merge fresh data, not stale fragments."""
    seqs, mono, tmp = case
    out = tmp / "rerun"
    _both_hosts(seqs, mono, out, run_multihost)
    first = _read(out / "final_decomposition.tsv")
    with open(seqs, "a") as f:
        f.write(">r4\nACGTACGTACGT\n")
    _both_hosts(seqs, mono, out, run_multihost)
    rows = _read(out / "final_decomposition.tsv").splitlines()
    assert any(r.startswith("r4\t") for r in rows)
    assert first != _read(out / "final_decomposition.tsv")
    _both_hosts(seqs, mono, tmp / "jax", j_mh.run_multihost)
    _same_as_jax(out, tmp / "jax")


def test_stale_heartbeat_cleaned_before_recompute(case):
    """A .alive file left by a previous run is removed before the DP stage
    (and on heartbeat exit): host 0's dead-host check would otherwise see an
    hours-old mtime and declare a merely slow host dead."""
    seqs, mono, tmp = case
    out = tmp / "stale_hb"
    out.mkdir()
    frag1 = mh.fragment_path(str(out), "final_decomposition", 1)
    with open(mh._heartbeat(frag1), "w") as f:
        f.write("0")  # ancient heartbeat from a "previous run"
    _both_hosts(seqs, mono, out, run_multihost)
    assert not os.path.exists(mh._heartbeat(frag1))
    assert (out / "final_decomposition.tsv").exists()
    _both_hosts(seqs, mono, tmp / "jax", j_mh.run_multihost)
    _same_as_jax(out, tmp / "jax")


def _salvage_with_slow_host1(seqs, mono, multi, runner, mod):
    """Host 1 of 3 computes its fragment, which is then hidden and replayed
    late under a heartbeat (slow but alive) once host 0 has salvaged dead
    host 2; host 0 must merge only after host 1's sentinel lands."""
    runner(seqs, mono, out_dir=str(multi), topology=HostTopology(3, 1), **COMMON)
    frag1 = mod.fragment_path(str(multi), "final_decomposition", 1)
    parts = [frag1, frag1 + ".reads", mod._sentinel(frag1)]  # sentinel restored last
    for p in parts:
        os.replace(p, p + ".hidden")
    frag2_done = mod._sentinel(mod.fragment_path(str(multi), "final_decomposition", 2))

    def slow_host1():
        with mod._HeartbeatThread(frag1, period=0.1):
            while not os.path.exists(frag2_done):
                time.sleep(0.05)
            time.sleep(1.0)
            for p in parts:
                os.replace(p + ".hidden", p)

    t = threading.Thread(target=slow_host1)
    t.start()
    try:
        out = runner(seqs, mono, out_dir=str(multi), topology=HostTopology(3, 0),
                     liveness_grace=0.5, **COMMON)
    finally:
        t.join(timeout=120)
    assert not t.is_alive()
    assert out is not None


def test_salvage_waits_for_live_hosts(case):
    seqs, mono, tmp = case
    run_single(seqs, mono, out_dir=str(tmp / "single"), **COMMON)
    _salvage_with_slow_host1(seqs, mono, tmp / "multi", run_multihost, mh)
    _same_as_single(tmp / "multi", tmp / "single")
    _salvage_with_slow_host1(seqs, mono, tmp / "jax", j_mh.run_multihost, j_mh)
    _same_as_jax(tmp / "multi", tmp / "jax")


def test_dead_host_salvage(case):
    """Host 1 never runs at all; host 0 detects the missing heartbeat,
    recomputes host 1's shard locally, and writes a one-process run's
    bytes."""
    seqs, mono, tmp = case
    run_single(seqs, mono, out_dir=str(tmp / "single"), **COMMON)
    for runner, d in ((run_multihost, "multi"), (j_mh.run_multihost, "jax")):
        out = runner(seqs, mono, out_dir=str(tmp / d), topology=HostTopology(2, 0),
                     liveness_grace=0.5, **COMMON)
        assert out is not None
    _same_as_single(tmp / "multi", tmp / "single")
    _same_as_jax(tmp / "multi", tmp / "jax")


def test_multihost_streaming_byte_identical(case):
    """--stream-reads with two hosts: streaming shards write the one-shot
    run's bytes, and a resumed host 0 (which skips its own compute and
    therefore never counted the input) still merges through its counting
    pass."""
    seqs, mono, tmp = case
    single, multi = tmp / "st_single", tmp / "st_multi"
    run_single(seqs, mono, out_dir=str(single), **COMMON)
    _both_hosts(seqs, mono, multi, run_multihost, stream_reads=1)
    _same_as_single(multi, single)
    _both_hosts(seqs, mono, tmp / "jax", j_mh.run_multihost, stream_reads=1)
    _same_as_jax(multi, tmp / "jax")
    for name in TSVS:
        os.remove(multi / name)
    out = run_multihost(seqs, mono, out_dir=str(multi), stream_reads=1, resume=True,
                        topology=HostTopology(2, 0), **COMMON)
    assert out is not None
    _same_as_single(multi, single)


def test_finishing_runs_on_every_host(case):
    """Each host rescores its OWN shard: host 1's final and alt fragments
    hold host 1's read (r2 under round-robin with 3 reads on 2 hosts), host
    0's the others, and the merge interleaves them exactly."""
    seqs, mono, tmp = case
    single, multi = tmp / "f_single", tmp / "f_multi"
    run_single(seqs, mono, out_dir=str(single), **COMMON)
    _both_hosts(seqs, mono, multi, run_multihost)
    ffrag1 = mh.final_fragment_path(str(multi), "final_decomposition", 1)
    assert os.path.exists(ffrag1)
    assert os.path.exists(mh.alt_fragment_path(str(multi), "final_decomposition", 1))
    rows1 = _read(ffrag1).splitlines()
    assert rows1 and all(r.startswith("r2\t") for r in rows1)
    rows0 = _read(mh.final_fragment_path(str(multi), "final_decomposition", 0)).splitlines()
    assert rows0 and not any(r.startswith("r2\t") for r in rows0)
    _same_as_single(multi, single, TSVS[1:])


@pytest.mark.parametrize("second_best,min_identity", [(False, 0), (True, 60), (False, 101)])
def test_light_mode_and_min_identity_match_jax(case, second_best, min_identity):
    """The final and alt sidecars count what write_final_rows writes under
    -i (alt rows only with --second-best), so the merge of a light-mode run
    and of runs that drop some or all blocks writes the JAX package's
    bytes."""
    seqs, mono, tmp = case
    kw = dict(COMMON, second_best=second_best, min_identity=min_identity)
    for h in (1, 0):
        run_multihost(seqs, mono, out_dir=str(tmp / "multi"), topology=HostTopology(2, h), **kw)
        j_mh.run_multihost(seqs, mono, out_dir=str(tmp / "jax"), topology=HostTopology(2, h),
                           **kw)
    _same_as_jax(tmp / "multi", tmp / "jax")
    run_single(seqs, mono, out_dir=str(tmp / "single"), **kw)
    _same_as_single(tmp / "multi", tmp / "single")


def test_data_parallel_on_each_host(case):
    """data_parallel=True shards each host's windows and pairs over its
    devices (the CPU, one device) with the sharded functions, and writes
    the bytes of the run without it."""
    seqs, mono, tmp = case
    _both_hosts(seqs, mono, tmp / "dp", run_multihost, data_parallel=True)
    _both_hosts(seqs, mono, tmp / "jax", j_mh.run_multihost)
    _same_as_jax(tmp / "dp", tmp / "jax")


def test_topology_without_a_process_group(monkeypatch):
    assert mh.detect_topology() == HostTopology(1, 0)
    assert mh.shard_indices(7, HostTopology(3, 1)) == j_mh.shard_indices(7, j_mh.HostTopology(3, 1))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        mesh.initialize_distributed("localhost:1", None, 0)


def test_cuda_without_a_card_raises(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs, mono, tmp = case
    with pytest.raises(RuntimeError, match="cuda"):
        mh.run_multihost(seqs, mono, out_dir=str(tmp / "o"), topology=HostTopology(2, 1))
    assert not (tmp / "o").exists()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_procs(seqs, mono, out, host_flags, timeout):
    """One port CLI process a host, all started together; each is killed at
    `timeout` seconds, so that no rank is left waiting on a rendezvous."""
    procs = [subprocess.Popen([sys.executable, "-m", "stringdecomposer_tpu_torch", seqs, mono,
                               "-o", str(out), *CLI_FLAGS, "--device", "cpu", *flags],
                              env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for flags in host_flags]
    deadline = time.monotonic() + timeout
    res = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            res.append((p.returncode, err.decode()))
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_coordinator_two_processes_match_jax_cli(case):
    """--coordinator localhost:<free port> --num-processes 2: two port CLI
    processes meet through torch.distributed (gloo) and write the JAX CLI's
    one-process bytes, within a 60 s limit of their own."""
    from stringdecomposer_tpu import cli as jax_cli

    seqs, mono, tmp = case
    assert jax_cli.main([seqs, mono, "-o", str(tmp / "jax"), *CLI_FLAGS]) == 0
    port = _free_port()
    res = _cli_procs(seqs, mono, tmp / "multi",
                     [["--coordinator", f"localhost:{port}", "--num-processes", "2",
                       "--host-id", str(h)] for h in (0, 1)], timeout=60)
    for rc, err in res:
        assert rc == 0, err[-3000:]
    assert (tmp / "multi" / "final_decomposition_raw.shard00001.tsv").exists()
    for name in TSVS:
        assert filecmp.cmp(tmp / "multi" / name, tmp / "jax" / name, shallow=False), name


@pytest.mark.slow
def test_concurrent_hosts_via_cli(case):
    """Three real processes cooperating through the shared out-dir, launched
    through the CLI as a cluster deployment would."""
    seqs, mono, tmp = case
    run_single(seqs, mono, out_dir=str(tmp / "single3"), **COMMON)
    res = _cli_procs(seqs, mono, tmp / "multi3",
                     [["--num-hosts", "3", "--host-id", str(h)] for h in range(3)], timeout=420)
    for rc, err in res:
        assert rc == 0, err[-3000:]
    _same_as_single(tmp / "multi3", tmp / "single3")


@pytest.mark.slow
def test_coordinator_path(case):
    """--coordinator with --host-id as the rank: torch.distributed bring-up,
    the topology from the process group, and the one-process run's final
    TSV."""
    seqs, mono, tmp = case
    run_single(seqs, mono, out_dir=str(tmp / "c_single"), **COMMON)
    port = _free_port()
    res = _cli_procs(seqs, mono, tmp / "c_multi",
                     [["--coordinator", f"localhost:{port}", "--num-processes", "2",
                       "--host-id", str(h)] for h in range(2)], timeout=420)
    for rc, err in res:
        assert rc == 0, err[-3000:]
    assert (tmp / "c_multi" / "final_decomposition_raw.shard00001.tsv").exists()
    assert _read(tmp / "c_multi" / "final_decomposition.tsv") == _read(
        tmp / "c_single" / "final_decomposition.tsv")
