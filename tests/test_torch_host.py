"""The port's own copies of the JAX package's host modules, and the rule
that the port imports nothing of the JAX package and nothing of JAX.

Each copied module (io/fasta, runtime/native, ops/oracle, ops/traceback,
report, models/reliability, utils/stagetimer, utils/logging, __version__)
against its JAX-package original on seeded inputs: equal values, equal
bytes, equal errors (tolerance 0 everywhere; the floats are the same
IEEE operations). Then an AST scan of the port's sources and chip_smoke.py,
and a CPU CLI run on the golden 12 kbp prefix under an import hook that
raises on the JAX package and on JAX, whose three TSVs must equal the JAX
package's byte for byte."""

import ast
import filecmp
import logging
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from stringdecomposer_tpu.__version__ import __version__ as jax_version
from stringdecomposer_tpu import report as j_report
from stringdecomposer_tpu.io import fasta as j_fasta
from stringdecomposer_tpu.models import reliability as j_rel
from stringdecomposer_tpu.ops import oracle as j_oracle
from stringdecomposer_tpu.ops import traceback as j_tb
from stringdecomposer_tpu.runtime import native as j_native
from stringdecomposer_tpu.utils import logging as j_logging
from stringdecomposer_tpu.utils import stagetimer as j_stage
from stringdecomposer_tpu_torch.__version__ import __version__ as t_version
from stringdecomposer_tpu_torch import report as t_report
from stringdecomposer_tpu_torch.io import fasta as t_fasta
from stringdecomposer_tpu_torch.models import reliability as t_rel
from stringdecomposer_tpu_torch.ops import oracle as t_oracle
from stringdecomposer_tpu_torch.ops import traceback as t_tb
from stringdecomposer_tpu_torch.runtime import native as t_native
from stringdecomposer_tpu_torch.utils import logging as t_logging
from stringdecomposer_tpu_torch.utils import stagetimer as t_stage

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "stringdecomposer_tpu_torch"
# one torch thread a subprocess: the suite's other workers share the cores
ENV = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
TSVS = ("final_decomposition_raw.tsv", "final_decomposition.tsv", "final_decomposition_alt.tsv")


def _rand_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), n))


def _blocks(mod, rng, n):
    """n random overlapping blocks in reading order, as the window merge
    emits them (some duplicates of the halo)."""
    out, pos = [], 0
    for _ in range(n):
        ln = int(rng.integers(5, 40))
        start = max(0, pos - int(rng.integers(0, 30)))
        out.append(mod.Block(int(rng.integers(0, 24)), start, start + ln,
                             float(rng.integers(-20, 180))))
        pos = start + ln + int(rng.integers(0, 5))
    return out


def _tuples(blocks):
    return [(b.monomer, b.start, b.end, b.identity) for b in blocks]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_and_validation(seed):
    rng = np.random.default_rng(seed)
    seqs = [_rand_seq(rng, int(rng.integers(1, 300)), "ACGTN") for _ in range(20)]
    for s in seqs:
        np.testing.assert_array_equal(t_fasta.encode(s), j_fasta.encode(s))
        assert t_fasta.decode(t_fasta.encode(s)) == j_fasta.decode(j_fasta.encode(s))
        assert t_fasta.reverse_complement(s) == j_fasta.reverse_complement(s)
    bad = seqs[0][:5] + "x" + seqs[0][5:]
    for mod in (t_fasta, j_fasta):
        with pytest.raises(mod.InvalidSymbolError) as info:
            mod.encode(bad)
        assert str(info.value) == "undefined symbol (not ACGTN): x"
    recs = [t_fasta.Record(f"r{i}", s) for i, s in enumerate(seqs)]
    msgs = []
    for mod in (t_fasta, j_fasta):
        with pytest.raises(mod.InvalidSymbolError) as info:
            mod.validate_acgtn(recs[:3] + [mod.Record("bad", "ACGu")], "in.fa")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "Sequence bad contains undefined symbol (not ACGT): u"


def test_validation_warns_on_n_like_jax(caplog):
    recs = [t_fasta.Record("r", "ACGNT")]
    with caplog.at_level(logging.WARNING, logger="SD-TPU"):
        t_fasta.validate_acgtn(recs, "a.fa")
        j_fasta.validate_acgtn(recs, "a.fa")
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 2 and msgs[0] == msgs[1] and "contain N symbol" in msgs[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_reverse_complement_doubling_and_fasta_io(seed, tmp_path):
    rng = np.random.default_rng(seed)
    fwd = [t_fasta.Record(f"m{i} extra words", _rand_seq(rng, int(rng.integers(50, 200))))
           for i in range(7)]
    path = tmp_path / "m.fa"
    t_fasta.write_fasta(str(path), fwd)
    text = path.read_text().replace("C", "c", 3)
    path.write_text(text)
    for upper in (False, True):
        t = t_fasta.load_fasta(str(path), upper=upper)
        j = j_fasta.load_fasta(str(path), upper=upper)
        assert [(r.name, r.seq) for r in t] == [(r.name, r.seq) for r in j]
        assert [(r.name, r.seq) for r in t_fasta.iter_fasta(str(path), upper=upper)] == \
            [(r.name, r.seq) for r in j]
    recs = t_fasta.load_fasta(str(path), upper=True)
    for name in ("add_reverse_complement", "add_rc_interleaved"):
        got = getattr(t_fasta, name)(recs)
        want = getattr(j_fasta, name)([j_fasta.Record(r.name, r.seq) for r in recs])
        assert [(r.name, r.seq) for r in got] == [(r.name, r.seq) for r in want]


@pytest.mark.parametrize("pad_to", [None, 200, 256])
def test_pad_monomers(pad_to):
    rng = np.random.default_rng(4)
    recs = [t_fasta.Record(f"m{i}", _rand_seq(rng, int(rng.integers(1, 200)), "ACGTN"))
            for i in range(9)]
    got, want = t_fasta.pad_monomers(recs, pad_to), j_fasta.pad_monomers(recs, pad_to)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    for mod in (t_fasta, j_fasta):
        with pytest.raises(ValueError, match="monomer longer than pad_to=3"):
            mod.pad_monomers(recs, 3)


def test_make_windows():
    for read_len in (0, 1, 499, 500, 501, 4999, 5000, 5001, 5499, 5500, 10_000, 94_871):
        for part, overlap in ((5000, 500), (1000, 0), (300, 299), (64, 128)):
            assert t_oracle.make_windows(read_len, part, overlap) == \
                j_oracle.make_windows(read_len, part, overlap)


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 700), (2, 3000)])
def test_postprocess_stream_python_and_native(seed, n):
    """PostprocessStream over random chunkings, and the batch postprocess
    (the native library above 1,024 blocks), against the JAX package's."""
    rng = np.random.default_rng(seed)
    tb = _blocks(t_oracle, rng, n)
    jb = [j_oracle.Block(*t) for t in _tuples(tb)]
    want = _tuples(j_oracle.postprocess(jb))
    assert _tuples(t_oracle.postprocess(tb)) == want
    for _ in range(3):
        cuts = np.sort(rng.integers(0, n + 1, int(rng.integers(1, 12))))
        outs = []
        for mod, blocks in ((t_oracle, tb), (j_oracle, jb)):
            stream, got, prev = mod.PostprocessStream(), [], 0
            for c in list(cuts) + [n]:
                got.extend(stream.push(blocks[prev:c]))
                prev = c
            got.extend(stream.finish())
            outs.append(_tuples(got))
        assert outs[0] == outs[1] == want


def test_native_library_builds_into_the_port(tmp_path):
    """The port builds libsdnative.so from its own copy of the source into
    its build directory, keyed by a hash, and its native calls agree with
    the JAX package's."""
    path = t_native.library_path()
    assert path.is_relative_to(PORT / "build") and path.name == "libsdnative.so"
    lib = t_native.load_native()
    assert lib is not None and pathlib.Path(lib._name) == path
    rng = np.random.default_rng(9)
    arr = np.array([[b.monomer, b.start, b.end, int(b.identity)]
                    for b in _blocks(t_oracle, rng, 400)], dtype=np.int32)
    np.testing.assert_array_equal(t_native.postprocess_native(arr),
                                  j_native.postprocess_native(arr))
    names = [f"m{i}'" if i % 2 else f"m{i}" for i in range(24)]
    assert t_native.format_raw_native(arr, "read7", names) == \
        j_native.format_raw_native(arr, "read7", names)
    codes = t_fasta.encode(_rand_seq(rng, 500))
    np.testing.assert_array_equal(t_native.homo_compress_native(codes),
                                  j_native.homo_compress_native(codes))


def test_blocks_from_device():
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 500, (40, 4)).astype(np.int32)
    for count in (0, 1, 17, 40):
        assert _tuples(t_tb.blocks_from_device(arr, count)) == \
            _tuples(j_tb.blocks_from_device(arr, count))


@pytest.mark.parametrize("prev_end", [0, 1234])
def test_format_raw_rows(prev_end):
    rng = np.random.default_rng(6)
    tb = _blocks(t_oracle, rng, 60)
    for b in tb:
        b.identity = float(rng.integers(-50, 200)) / 7
    names = [f"m{i}" for i in range(24)]
    got = t_report.format_raw_rows("read", tb, names, prev_end=prev_end)
    want = j_report.format_raw_rows("read", [j_oracle.Block(*t) for t in _tuples(tb)], names,
                                    prev_end=prev_end)
    assert got == want
    text = "".join(r + "\n" for r in got)
    assert t_report.parse_raw_tsv(text) == j_report.parse_raw_tsv(text)


@pytest.mark.parametrize("with_alt", [False, True])
def test_format_final_native(with_alt):
    """sd_format_final through each package's loader on the same random
    rows: byte-equal final and alt chunks."""
    rng = np.random.default_rng(7)
    names = ["m1", "m2", "m1", "a_longer_name", "m3'"]
    uniq = ["m1", "m2", "a_longer_name", "m3'"]
    n = 50
    pool = np.concatenate([(rng.integers(0, 200, 64) / rng.integers(1, 200, 64)) * 100.0,
                           np.array([96.875, 0.125, 0.0, -1.0, 100.0])])
    best = rng.integers(0, len(names), n).astype(np.int32)
    upos = np.array([uniq.index(names[i]) for i in best], np.int32)
    args = ("readX", names, uniq, best, upos,
            rng.integers(0, 10**7, n).astype(np.int64), rng.integers(0, 10**7, n).astype(np.int64),
            rng.choice(pool, n), rng.integers(-1, len(uniq), n).astype(np.int32),
            rng.choice(pool, n), rng.integers(0, len(names), n).astype(np.int32),
            rng.choice(pool, n), rng.integers(-1, len(names), n).astype(np.int32),
            rng.choice(pool, n), rng.integers(0, 2, n).astype(bool),
            rng.choice(pool, (n, len(uniq))) if with_alt else None, 60)
    got, want = t_native.format_final_native(*args), j_native.format_final_native(*args)
    assert got is not None and got == want and got[0]


def test_reliability_classify_and_coefficients(tmp_path):
    np.testing.assert_array_equal(t_rel.load_coefficients(), j_rel.load_coefficients())
    assert (PORT / "models" / "ont_logreg_model.txt").read_bytes() == \
        (REPO / "stringdecomposer_tpu" / "models" / "ont_logreg_model.txt").read_bytes()
    rng = np.random.default_rng(8)
    scores = rng.uniform(0, 100, 500)
    second = np.where(rng.random(500) < 0.2, -1.0, scores - rng.uniform(0, 30, 500))
    np.testing.assert_array_equal(t_rel.classify(scores, second), j_rel.classify(scores, second))
    coef = np.array([-5.0, 0.1, 0.2])
    path = tmp_path / "c.txt"
    path.write_text("-5.0 0.1 0.2\n")
    np.testing.assert_array_equal(t_rel.load_coefficients(str(path)), coef)
    np.testing.assert_array_equal(t_rel.classify(scores, second, coef),
                                  j_rel.classify(scores, second, coef))


def test_stagetimer_and_logger(tmp_path):
    for mod in (t_stage, j_stage):
        mod.enable()
        with mod.stage("dp.prep"):
            pass
        with mod.stage("dp.prep"):
            pass
        assert mod.counts() == {"dp.prep": 2} and set(mod.snapshot()) == {"dp.prep"}
        mod.disable()
        assert mod.stage("x") is mod._NULL
    lg = t_logging.get_logger(str(tmp_path / "a.log"), logger_name="SD-TPU-test")
    assert lg is j_logging.get_logger(str(tmp_path / "a.log"), logger_name="SD-TPU-test")
    lg.info("hello")
    for h in list(lg.handlers):
        lg.removeHandler(h)
        h.close()
    assert "SD-TPU-test - INFO - hello" in (tmp_path / "a.log").read_text()
    assert t_version == jax_version == "0.1.0"


def _imports(path: pathlib.Path) -> list[tuple[int, str]]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.lineno, node.module))
    return out


def test_no_module_of_the_port_imports_the_jax_package_or_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}" for f in files
           for line, mod in _imports(f)
           if mod.split(".")[0] in ("stringdecomposer_tpu", "jax", "jaxlib")]
    assert not bad, bad


def test_no_module_of_the_port_imports_the_jax_projects_scripts():
    """Nor a module of the JAX project's top-level scripts (scripts/*.py,
    bench.py and the other top-level files), which run the JAX package:
    the port keeps its own copy of what it needs from them."""
    theirs = {p.stem for p in (REPO / "scripts").glob("*.py")}
    theirs |= {p.stem for p in REPO.glob("*.py")} - {"chip_smoke"}
    assert {"scale_smoke", "bench"} <= theirs
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}" for f in files
           for line, mod in _imports(f) if mod.split(".")[0] in theirs]
    assert not bad, bad


def _load(path: pathlib.Path, name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1])
def test_chip_smoke_synthesize_matches_scale_smoke(seed, test_data_dir):
    """chip_smoke's copy of scripts/scale_smoke.synthesize (the port's
    scripts/workloads.synthesize, which chip_smoke imports) draws the same
    assembly from the same seed (exact string equality)."""
    from stringdecomposer_tpu_torch.scripts.workloads import synthesize as ours

    theirs = _load(REPO / "scripts" / "scale_smoke.py", "_scale_smoke").synthesize
    monomers = j_fasta.load_fasta(os.path.join(test_data_dir, "DXZ1_star_monomers.fa"))
    a = ours(20_000, monomers, np.random.default_rng(seed))
    assert len(a) == 20_000
    assert a == theirs(20_000, monomers, np.random.default_rng(seed))


JAX_DATA = ("read.fa", "DXZ1_star_monomers.fa", "final_decomposition_fc89af8.tsv",
            "raw_decomposition_oracle.tsv")


@pytest.mark.parametrize("name", JAX_DATA)
def test_the_ports_test_data_is_a_copy_of_the_jax_packages(name, test_data_dir):
    """The golden read, the DXZ1 monomers and both golden TSVs the port
    reads from its own test_data/ are byte-equal to the JAX package's."""
    assert (PORT / "test_data" / name).read_bytes() == (test_data_dir / name).read_bytes()


# a string that names a TPU kernel by file and line (chip_smoke's `replaces`),
# which opens nothing
KERNEL_AT = re.compile(r"stringdecomposer_tpu/[\w/]+\.py:\d+")


def _jax_package_paths(source: str, where: str) -> list[str]:
    """The string constants of a module's code (not its docstrings or other
    bare strings) that reach a file of the JAX package: the directory name
    as a path component ("stringdecomposer_tpu", as a path join or a Path's
    `/` takes it) or a path under it, but for KERNEL_AT's names."""
    tree = ast.parse(source, where)
    bare = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Constant) or not isinstance(node.value, str) \
                or id(node) in bare:
            continue
        v = node.value
        if v.strip("/\\") == "stringdecomposer_tpu" or (
                re.search(r"stringdecomposer_tpu[/\\]", v) and not KERNEL_AT.fullmatch(v)):
            out.append(f"{where}:{node.lineno}: {v!r}")
    return out


def test_no_module_of_the_port_opens_a_file_of_the_jax_package():
    """No module of the port and not chip_smoke.py names a path under
    stringdecomposer_tpu/ (its test_data or any other file there): the port
    reads its own copies. The scan finds the forms such a path took before
    (a path join, a Path's `/`, a string)."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [b for f in files for b in _jax_package_paths(f.read_text(), str(f.relative_to(REPO)))]
    assert not bad, bad
    for old in ('DATA = os.path.join(HERE, "stringdecomposer_tpu", "test_data")',
                'DATA = Path(__file__).resolve().parents[2] / "stringdecomposer_tpu" / "test_data"',
                'open("stringdecomposer_tpu/test_data/read.fa")',
                'f = f"{HERE}/stringdecomposer_tpu/models/ont_logreg_model.txt"'):
        assert _jax_package_paths(old, "old"), old
    assert not _jax_package_paths('"""Reads stringdecomposer_tpu/test_data."""\n'
                                  'r = ("k1", "stringdecomposer_tpu/ops/chain_dp_pallas.py:131")',
                                  "ok")


OPEN_HOOK = """
import os, sys

opened = []

def refuse(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        path = os.path.realpath(os.fsdecode(args[0]))
        opened.append(path)
        if path.startswith(sys.argv[1] + os.sep):
            raise PermissionError(f"opened a file of the JAX package: {path}")

sys.addaudithook(refuse)
from stringdecomposer_tpu_torch import cli
rc = cli.main(sys.argv[3:])
assert any(p.startswith(sys.argv[2] + os.sep) for p in opened), "no file of the port's data opened"
sys.exit(rc)
"""


def test_cpu_cli_opens_no_file_of_the_jax_package(tmp_path):
    """The port's CLI (--device cpu --second-best) on the golden read's first
    3 kbp from the port's test_data, under an audit hook that refuses to open
    any file under stringdecomposer_tpu/ (and which does refuse one)."""
    read = t_fasta.load_fasta(str(PORT / "test_data" / "read.fa"))[0]
    fa = tmp_path / "read3k.fa"
    t_fasta.write_fasta(str(fa), [t_fasta.Record(read.name, read.seq[:3000])])
    jax_dir, data = str(REPO / "stringdecomposer_tpu"), str(PORT / "test_data")
    mono = str(PORT / "test_data" / "DXZ1_star_monomers.fa")
    res = subprocess.run(
        [sys.executable, "-c", OPEN_HOOK, jax_dir, data, str(fa), mono, "-o", str(tmp_path / "o"),
         "--device", "cpu", "--second-best"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (tmp_path / "o" / TSVS[0]).read_text().splitlines()
    res = subprocess.run(
        [sys.executable, "-c", OPEN_HOOK, jax_dir, data,
         str(REPO / "stringdecomposer_tpu" / "test_data" / "read.fa"), mono,
         "-o", str(tmp_path / "o2"), "--device", "cpu"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=600)
    assert res.returncode != 0 and "opened a file of the JAX package" in res.stderr


HOOK = """
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("stringdecomposer_tpu", "jax", "jaxlib"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
from stringdecomposer_tpu_torch import cli
rc = cli.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("stringdecomposer_tpu", "jax"))
assert not bad, bad
sys.exit(rc)
"""


def test_cpu_cli_with_the_jax_package_blocked_matches_jax(tmp_path, test_data_dir):
    """The port's CLI (--device cpu --second-best) on the golden read's
    first 12 kbp, with any import of the JAX package or of JAX raising:
    its three TSVs equal the JAX package's byte for byte."""
    from stringdecomposer_tpu.pipeline import run as jax_run

    read = j_fasta.load_fasta(test_data_dir / "read.fa")[0]
    fa = tmp_path / "read12k.fa"
    j_fasta.write_fasta(str(fa), [j_fasta.Record(read.name, read.seq[:12000])])
    mono = str(test_data_dir / "DXZ1_star_monomers.fa")
    jax_run(str(fa), mono, out_dir=str(tmp_path / "jax"), second_best=True)
    res = subprocess.run(
        [sys.executable, "-c", HOOK, str(fa), mono, "-o", str(tmp_path / "torch"),
         "--device", "cpu", "--second-best"],
        capture_output=True, text=True, env=ENV, cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    for f in TSVS:
        assert filecmp.cmp(tmp_path / "torch" / f, tmp_path / "jax" / f, shallow=False), f
    assert (tmp_path / "torch" / TSVS[0]).stat().st_size > 0


def test_hook_blocks_the_jax_package(tmp_path):
    """The import hook of the CLI test does refuse the JAX package."""
    code = HOOK.replace("from stringdecomposer_tpu_torch import cli\n"
                        "rc = cli.main(sys.argv[1:])\n", "import stringdecomposer_tpu.io.fasta\nrc = 0\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV,
                         cwd=tmp_path, timeout=120)
    assert res.returncode != 0 and "blocked import of stringdecomposer_tpu" in res.stderr


STRESS = {"stress_kernel": ["3", "5", "--device", "cpu", "--body", "lanes", "split"],
          "stress_rescoring": ["3", "5", "--device", "cpu"],
          "stress_m_scale": ["--quick", "--device", "cpu"]}


@pytest.mark.parametrize("name", sorted(STRESS))
def test_stress_scripts_run_with_the_jax_package_blocked(tmp_path, name):
    """The port's stress scripts import nothing of the JAX package or JAX
    (in their source, and in a run of their main on the CPU under the CLI
    test's import hook), unlike the JAX project's scripts of the same name."""
    path = PORT / "scripts" / f"{name}.py"
    bad = [(line, mod) for line, mod in _imports(path)
           if mod.split(".")[0] in ("stringdecomposer_tpu", "jax", "jaxlib")]
    assert not bad, bad
    code = HOOK.replace("from stringdecomposer_tpu_torch import cli\n"
                        "rc = cli.main(sys.argv[1:])\n",
                        f"from stringdecomposer_tpu_torch.scripts import {name}\n"
                        f"rc = {name}.main(sys.argv[1:])\n")
    assert code != HOOK
    res = subprocess.run([sys.executable, "-c", code, *STRESS[name]], capture_output=True,
                         text=True, env=ENV, cwd=tmp_path, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "DONE: 0 failures" in res.stdout


def test_write_raw_tsv(tmp_path):
    """write_raw_tsv of each package on the same blocks: equal bytes."""
    rng = np.random.default_rng(10)
    per_read = [(f"r{i}", _blocks(t_oracle, rng, 20)) for i in range(3)]
    names = [f"m{i}" for i in range(24)]
    t_report.write_raw_tsv(str(tmp_path / "t.tsv"), per_read, names)
    j_report.write_raw_tsv(str(tmp_path / "j.tsv"), [
        (r, [j_oracle.Block(*t) for t in _tuples(b)]) for r, b in per_read], names)
    assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
    assert (tmp_path / "t.tsv").read_text().count("\n") == 60
