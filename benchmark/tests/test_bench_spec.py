"""BENCHMARK.json keeps to the contract's form, and every part it names
is found by name: a configuration, a traffic mix or a metric is a file,
and a new one needs no other edit."""

import json
import re
import shutil

import pytest
from harness import inputs, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = spec.benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and c["file"].startswith("benchmark/")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_parts(w):
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"] and (spec.ROOT / cfg["monomers"]["file"]).exists()
    assert spec.traffic(w["traffic"])["loop"] == "closed"
    e2e = spec.metrics_for(BENCH, w["name"], trace=False)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert spec.metrics_for(BENCH, w["name"], trace=True)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(m):
    assert callable(spec.reader(m["name"]))


def test_a_new_traffic_file_needs_no_other_edit(tmp_path, monkeypatch):
    shutil.copytree(spec.BENCH_DIR / "traffic", tmp_path / "traffic")
    shutil.copytree(spec.BENCH_DIR / "configs", tmp_path / "configs")
    new = dict(spec.traffic("assembly"), clients=2, warm_bp=1000)
    (tmp_path / "traffic" / "pairs2.json").write_text(json.dumps(new))
    monkeypatch.setattr(spec, "BENCH_DIR", tmp_path)
    cfg = dict(spec.config("cenx_dxz1"), array={"bp": 6000, "divergence": [0.01, 0.02]})
    got = inputs.make(cfg, spec.traffic("pairs2"), 7, str(tmp_path))
    assert len(got.jobs) == 2 and got.jobs[0].bp == 6000 and got.warm[1][0].bp == 1000
    assert got.jobs[0].seq != got.jobs[1].seq  # each client its own array


@pytest.mark.parametrize("clients", [1, 3])
def test_inputs_repeat_for_a_seed_and_keep_their_sizes(tmp_path, clients):
    cfg = dict(spec.config("cenx_dxz1"), array={"bp": 60_000, "divergence": [0.01, 0.02]})
    tr = dict(spec.traffic("assembly"), clients=clients, warm_bp=9_000)
    runs = []
    for sub, seed in (("a", 2**31 + 3), ("b", 2**31 + 3), ("c", 11)):
        (tmp_path / sub).mkdir()
        runs.append(inputs.make(cfg, tr, seed, str(tmp_path / sub)))
    a, b, c = runs
    assert [x.seq for x in a.jobs] == [x.seq for x in b.jobs] and a.phase == b.phase
    assert a.monomers == b.monomers == c.monomers and len(a.monomers) == 12
    # another seed: arrays of the same size on other sequence
    assert [x.bp for x in a.jobs] == [x.bp for x in c.jobs] == [60_000] * clients
    assert all(x.seq != y.seq for x, y in zip(a.jobs, c.jobs))
    assert [w[0].seq for w in a.warm] == [x.seq[:9_000] for x in a.jobs]


def test_the_harness_refuses_a_mix_it_cannot_run(tmp_path):
    tr = dict(spec.traffic("assembly"), loop="open")
    with pytest.raises(ValueError, match="closed loops of arrays"):
        inputs.make(spec.config("cenx_dxz1"), tr, 1, str(tmp_path))
