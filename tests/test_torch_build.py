"""gyroflow_torch._build on the CPU, with a stand-in for nvcc.

The build compiles each csrc/*.cu with its own nvcc process, all started
together, then links the objects with one more call. A small Python script
takes nvcc's place: it records its arguments, writes the file named by -o and
prints a ptxas-like line, so the commands, the log and the failure path are
checked without a CUDA toolkit.
"""
import json
import sys

import pytest

from gyroflow_torch import _build

FAKE_NVCC = """#!{python}
import json, os, sys, time
args = sys.argv[1:]
with open({calls!r}, "a") as f:
    f.write(json.dumps([time.time(), args]) + "\\n")
srcs = [a for a in args if a.endswith(".cu")]
if any(s.endswith("bad.cu") for s in srcs):
    sys.stderr.write("bad.cu(1): error: expected a ';'\\n")
    sys.exit(2)
time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "0")) if srcs else 0.0)
for s in srcs:
    sys.stderr.write(f"ptxas info    : Compiling entry function 'k' for 'sm_90a' ({{s}})\\n")
open(args[args.index("-o") + 1], "w").write("built")
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    (csrc / "common.cuh").write_text("// header\n")
    calls = tmp_path / "calls.jsonl"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, calls=str(calls)))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    return csrc, calls


def _calls(path):
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_one_compile_per_source_then_one_link(fake_tree, monkeypatch):
    csrc, calls = fake_tree
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1.0")
    out = _build.build(verbose=True)
    assert out.exists() and out == _build.library_path()
    recorded = _calls(calls)
    compiles = [a for _, a in recorded if "-c" in a]
    links = [a for _, a in recorded if "-c" not in a]
    assert sorted(a[a.index("-c") + 1] for a in compiles) == \
        [str(csrc / n) for n in ("a.cu", "b.cu", "c.cu")]
    for a in compiles:
        assert "-shared" not in a and a[:len(_build.NVCC_FLAGS) - 1] == \
            [f for f in _build.NVCC_FLAGS if f != "-shared"]
        assert a[a.index("-Xptxas") + 1] == "-v"
    assert len(links) == 1
    assert links[0][:len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
    assert sorted(p.rsplit("/", 1)[-1] for p in links[0] if p.endswith(".o")) == \
        ["a.o", "b.o", "c.o"]
    # the compiles run together: each sleeps 1 s, all started before any ended
    starts = sorted(t for t, a in recorded if "-c" in a)
    assert starts[-1] - starts[0] < 1.0
    assert _build.build_log.count("Compiling entry function") == 3
    # objects are cleaned up; an unchanged tree loads from disk without nvcc
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    calls.unlink()
    assert _build.build() == out and not calls.exists()


def test_edited_source_rebuilds(fake_tree):
    csrc, _ = fake_tree
    first = _build.build()
    (csrc / "b.cu").write_text("// b.cu, edited\n")
    assert _build.library_path() != first
    assert _build.build().exists()


def test_failed_compile_raises_and_leaves_no_library(fake_tree):
    csrc, _ = fake_tree
    (csrc / "bad.cu").write_text("int x\n")
    with pytest.raises(RuntimeError, match="expected a ';'"):
        _build.build()
    build_dir = _build.BUILD_DIR
    assert not _build.library_path().exists()
    assert [p for p in build_dir.iterdir() if p.suffix == ".so" or p.is_dir()] == []
