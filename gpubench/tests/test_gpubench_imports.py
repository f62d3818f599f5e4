"""Nothing the benchmark runs imports JAX or the JAX package.

Module names are compared by their top-level name, whole: the port
`anatomix_tpu_torch` begins with the JAX package's name `anatomix_tpu`.
"""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "anatomix_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not (
                node.level):
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        tops = _imports(path)
        assert "anatomix_tpu_torch" not in tops, path
        assert tops <= {"__future__", "contextlib", "math", "typing",
                        "numpy", "torch"}, (path, tops)


def test_a_run_loads_no_jax_module():
    """A small cell run on the CPU, in a fresh process, then the whole
    `sys.modules` by top-level name."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from gpubench import env
        env.setup()
        from gpubench import harness
        bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
        cfg = harness.load_json(harness.HERE / "configs/anatomix-dev.json")
        cfg["unet"].update(ngf=4, num_downs=2)
        tr = harness.load_json(harness.HERE / "traffic/extract-192.json")
        tr.update(size=[20, 20, 20], roi=[16, 16, 16], overlap=0.5,
                  check_within=1)
        harness.run_cell(bench, "dev-sliding-192", 3, 0.1, True,
                         t_start=time.perf_counter(), device="cpu",
                         config=cfg, traffic=tr)
        for name in ("jax", "jaxlib", "flax", "anatomix_tpu"):
            assert not any(m.split(".")[0] == name for m in sys.modules), name
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("clean")


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from gpubench import harness

    monkeypatch.setitem(sys.modules, "anatomix_tpu_torch_fake", object())
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in FORBIDDEN for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "anatomix_tpu.fake", object())
    assert "anatomix_tpu.fake" in harness.forbidden_modules()


def _main_on_cpu(reader_loads: str | None) -> subprocess.CompletedProcess:
    """`harness.main` for a small dev cell on the CPU (the card's look
    answered yes, the run moved to the CPU), in a fresh process; with
    `reader_loads`, every metric reader makes that module loaded as it
    reads, as a reader that imports it would."""
    code = textwrap.dedent(f"""
        import sys, time, types
        sys.path.insert(0, {str(ROOT)!r})
        from gpubench import env
        env.setup()
        import torch
        from gpubench import harness
        torch.cuda.is_available = lambda: True
        torch.cuda.device_count = lambda: 1
        torch.cuda.set_device = lambda d: None
        cfg = harness.load_json(harness.HERE / "configs/anatomix-dev.json")
        cfg["unet"].update(ngf=4, num_downs=2)
        tr = harness.load_json(harness.HERE / "traffic/extract-192.json")
        tr.update(size=[20, 20, 20], roi=[16, 16, 16], overlap=0.5,
                  check_within=1)
        run_cell = harness.run_cell
        harness.run_cell = lambda *a, **k: run_cell(
            *a, **dict(k, device="cpu", config=cfg, traffic=tr))
        loads = {reader_loads!r}
        if loads:
            reader = harness.metric_reader
            def loading(name):
                read = reader(name)
                def load_then_read(rec):
                    sys.modules.setdefault(loads, types.ModuleType(loads))
                    return read(rec)
                return load_then_read
            harness.metric_reader = loading
        sys.exit(harness.main(["--workload", "dev-sliding-192", "--seed",
                               "3", "--seconds", "0.1"], time.perf_counter()))
    """)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("loads", [None, "jax", "anatomix_tpu.extract"])
def test_a_module_loaded_by_a_metric_reader_fails_the_run(loads):
    """The look at `sys.modules` comes after every reader has run: a
    forbidden module that a reader loads gives exit 3 and no result."""
    out = _main_on_cpu(loads)
    if loads is None:
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
    else:
        assert out.returncode == 3, out.stderr[-3000:]
        assert out.stdout.strip() == ""
        assert loads in out.stderr
