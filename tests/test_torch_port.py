"""gyroflow_torch stands alone: no jax and nothing of gyroflow_tpu.

- Every ``.py`` of the port, and ``chip_smoke.py``, is walked with ``ast``:
  no import of ``jax``, ``jaxlib``, ``gyroflow_tpu`` or the repository's
  ``bench`` (the JAX bench).
- The host modules the port carries are copies of the JAX package's modules
  at the same path. Each copy must equal its original once the import lines
  are normalised (``gyroflow_tpu`` -> ``gyroflow_torch``) and the reference
  citations are read as ``gyroflow src/...`` (the originals cite a local
  checkout of the reference), and once the port's tracer is taken out: the
  line ``from .. import trace`` and each ``with trace.span(...):`` line go,
  and the body of each such block is dedented to the block's own level.
  Files that are meant to differ are listed in ``MEANT_TO_DIFFER`` with the
  reason. The port's rewrites of scripts that
  lie outside the JAX package are listed in ``REWRITES`` with their
  originals.

The import hook test (every module imports with jax and gyroflow_tpu
blocked) is ``test_torch_manager.py::test_port_runs_with_jax_blocked``.
"""
import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "gyroflow_torch"
REF = REPO / "gyroflow_tpu"
FORBIDDEN = ("jax", "jaxlib", "gyroflow_tpu", "bench")

MEANT_TO_DIFFER = {
    "__init__.py": "the port's own package docstring",
    "core/manager.py": "rewritten for torch devices and the CUDA remap",
    "ops/remap.py": "torch twin of the JAX remap",
    "ops/mesh.py": "torch twin of the JAX mesh stage",
    "ops/distortion_models.py": "torch twin of the JAX models",
    "ops/kernel_params.py": "jax-free copy: the jnp annotations are dropped",
    "native/__init__.py": "its own build cache (gyroflow_torch/build/native) and env names",
    "parallel/pipeline.py": "the window sharded over a (dp, sp) grid of torch devices: no "
                            "shard_map, no window ladder, no XLA fallback",
    "parallel/__init__.py": "also exports the port's FrameMesh and stack_meshes",
    "render/renderer.py": "stabilizes on the manager's torch device and its cards (the dp/sp "
                          "rule in plan_window): no jax backend pick, no overflow replay, "
                          ".cpu() before the encode",
    "cli.py": "its own name and a --device option (the manager's device)",
    "utils/stmap.py": "the undistort map's grid and projection on the manager's torch "
                      "device (the coords kernel on a card)",
    "render/dng_seq.py": "bounds every IFD count and offset by the file and raises only "
                         "ValueError (DNGError) on a damaged file",
    "ops/frame_transform.py": "builds the per-row table in one pass of native/ft_rows.cpp, with "
                              "the numpy build as its fallback (tests/test_torch_ft_rows.py "
                              "holds it to the JAX frame transform)",
}

# port modules rewritten from a script of the repository outside the JAX
# package (no copy: they run the port's path on torch devices)
REWRITES = {
    "bench.py": "bench.py",
    "experiments/prod_path_probe.py": "experiments/prod_path_probe.py",
    "experiments/renderer_loop_bench.py": "experiments/renderer_loop_bench.py",
    "experiments/host_pipeline_bench.py": "experiments/host_pipeline_bench.py",
    "experiments/window_dispatch_probe.py": "experiments/window_dispatch_probe.py",
}


def _port_files():
    return sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                  if "build" not in p.relative_to(PORT).parts)


COPIES = [f for f in _port_files() if (REF / f).is_file() and f not in MEANT_TO_DIFFER]


def _imports(path: Path):
    for n in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(n, ast.Import):
            yield from ((n.lineno, a.name) for a in n.names)
        elif isinstance(n, ast.ImportFrom) and n.level == 0:
            yield n.lineno, n.module or ""


def test_no_jax_or_reference_imports():
    files = [PORT / f for f in _port_files()] + [REPO / "chip_smoke.py"]
    assert len(files) > 80
    bad = [f"{p.relative_to(REPO)}:{line}: {name}" for p in files
           for line, name in _imports(p) if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


_REF_CITE = re.compile(r"/\w+/reference/")


_SPAN = re.compile(r"( *)with trace\.span\(.*\):$")


def _normalise(text: str) -> str:
    out = []
    spans = []    # the indents of the open ``with trace.span(...):`` blocks
    for line in _REF_CITE.sub("gyroflow ", text).splitlines():
        if line.strip():
            indent = len(line) - len(line.lstrip(" "))
            while spans and indent <= spans[-1]:
                spans.pop()
            span = _SPAN.fullmatch(line)
            if span:
                spans.append(len(span.group(1)))
                continue
            if line == "from .. import trace":
                continue
            cut = 4 * len(spans)
            if line[:cut].strip() == "":
                line = line[cut:]
        if line.lstrip().startswith(("import ", "from ")):
            line = line.replace("gyroflow_tpu", "gyroflow_torch")
        out.append(line)
    return "\n".join(out)


def test_copies_are_listed():
    """The copies and the files meant to differ together cover every port
    module with a counterpart in the JAX package, and each file meant to
    differ does differ."""
    assert len(COPIES) > 60
    for f, why in MEANT_TO_DIFFER.items():
        assert (PORT / f).is_file(), f
        if (REF / f).is_file():
            assert _normalise((PORT / f).read_text()) != _normalise((REF / f).read_text()), \
                f"{f} equals its original: drop it from MEANT_TO_DIFFER ({why})"
    for f, original in REWRITES.items():
        assert (PORT / f).is_file() and (REPO / original).is_file(), (f, original)
        assert not (REF / f).is_file() and f not in MEANT_TO_DIFFER, f
        assert (PORT / f).read_text() != (REPO / original).read_text(), f


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_faithful(rel):
    assert _normalise((PORT / rel).read_text()) == _normalise((REF / rel).read_text())


def test_data_files_are_copied():
    """The native source and the camera presets the lens database finds next
    to its own file."""
    assert (PORT / "native/gyroflow_native.cpp").read_bytes() == \
        (REF / "native/gyroflow_native.cpp").read_bytes()
    ref = sorted(p.name for p in (REF / "resources/camera_presets").iterdir())
    assert ref and sorted(p.name for p in (PORT / "resources/camera_presets").iterdir()) == ref
    for name in ref:
        assert (PORT / "resources/camera_presets" / name).read_bytes() == \
            (REF / "resources/camera_presets" / name).read_bytes()
