"""BENCHMARK.json and the files it names: present, well formed, consistent."""

import json
import math
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=CELLS)
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    assert limits and all(math.isfinite(v) and v > 0
                          for v in limits.values())
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entries(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    from gpubench import harness

    assert callable(harness.metric_reader(metric["name"]))
    assert set(metric.get("workloads", [])) <= set(CELLS)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert "\n" not in metric["layer"]
        for cell in metric["workloads"]:
            moved = next(m for m in BENCH["end_to_end"]
                         if m["name"] == metric["moves"])
            assert cell in moved.get("workloads", CELLS)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    from gpubench import harness

    for cell in CELLS:
        e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_is_the_registry_variant(config):
    """The file holds the published constructor arguments, nothing cut."""
    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS

    data = json.loads((ROOT / config["file"]).read_text())
    assert config["reduced"] == data["reduced"] == []
    variant = {"anatomix-6m": "anatomix",
               "anatomix-dev": "anatomix-dev"}[config["name"]]
    published = ANATOMIX_VARIANTS[variant]["unet_kwargs"]
    for key, value in published.items():
        assert data["unet"][key] == value, key
    assert config["file"].startswith("gpubench/")


def test_no_file_outside_the_character_set():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel
