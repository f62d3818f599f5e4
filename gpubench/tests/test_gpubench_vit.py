"""The `vit-sliding-192` cell: its configuration, its counts, and its check
on the CPU.

As `test_gpubench_faults.py` does for the UNet cells: `harness.run_cell`
with `device='cpu'` at a small size, with the cell's own limits, for the
program as it is, the control, and the program broken underneath (one
corner of each window's answer altered; half of each window batch left out
with the rest's outputs in its place).
"""

import json
import time

import pytest
import torch

from gpubench import harness, work_vit
from gpubench.drivers.extract_vit import reference_config
from gpubench.tests.test_gpubench_imports import _imports

CELL = "vit-sliding-192"
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
ENTRY = harness.find_cell(BENCH, CELL)
CONFIG = harness.load_json(harness.HERE / "configs"
                           / f"{ENTRY['config']}.json")
# input 16^3, embed 24, 2 heads of 12, 2 blocks, 2 registers, tokenizer
# base 4; the registry entry's options otherwise
SMALL_VIT = dict(embed_dim=24, eva_depth=2, eva_numheads=2,
                 input_shape=[16, 16, 16], num_register_tokens=2,
                 num_classes=8, tokenizer_base_features=4)
# W * C = 256: the fold exit runs, as at the cell's size
SMALL_TRAFFIC = dict(size=[24, 20, 32], overlap=0.5, check_within=2)


def _run(control=False):
    cfg = json.loads(json.dumps(CONFIG))
    cfg["vit"].update(SMALL_VIT)
    tr = harness.load_json(harness.HERE / "traffic"
                           / f"{ENTRY['traffic']}.json")
    tr.update(SMALL_TRAFFIC)
    result, _ = harness.run_cell(BENCH, CELL, 2 ** 32 + 9, 0.2, False,
                                 t_start=time.perf_counter(), device="cpu",
                                 config=cfg, traffic=tr, control=control)
    return result


def test_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"mean_err", "max_err"}


def test_control_is_not_correct():
    r = _run(control=True)
    assert not r["correct"], r["checks"]


def test_altered_answer_is_not_correct(monkeypatch):
    from anatomix_tpu_torch.models.vit3d.primus import Primus

    forward = Primus.forward

    def altered(self, *args, **kwargs):
        y = forward(self, *args, **kwargs).clone()
        y[:, :4, :4, :4] += y.float().std().to(y.dtype)
        return y

    monkeypatch.setattr(Primus, "forward", altered)
    r = _run()
    assert not r["correct"], r["checks"]


def test_half_batch_left_out_is_not_correct(monkeypatch):
    import anatomix_tpu_torch.extract as ext

    swi = ext.sliding_window_inference

    def half(volume, apply_fn, *args, **kwargs):
        def first_half(windows):
            n = max(1, len(windows) // 2)
            y = apply_fn(windows[:n])
            return torch.cat([y, y[:len(windows) - n]])
        return swi(volume, first_half, *args, **kwargs)

    monkeypatch.setattr(ext, "sliding_window_inference", half)
    r = _run()
    assert not r["correct"], r["checks"]


def test_config_is_the_registry_variant():
    """The file holds the published constructor arguments, nothing cut, and
    the defaults it states are the port's `PrimusConfig`'s."""
    from anatomix_tpu_torch.models.registry import ANATOMIX_VARIANTS
    from anatomix_tpu_torch.models.vit3d import PrimusConfig

    entry = next(c for c in BENCH["configs"] if c["name"] == ENTRY["config"])
    assert entry["reduced"] == CONFIG["reduced"] == []
    assert entry["file"] == f"gpubench/configs/{ENTRY['config']}.json"
    published = ANATOMIX_VARIANTS["anatomix-dev-vit"]["vit_kwargs"]
    as_lists = {k: list(v) if isinstance(v, tuple) else v
                for k, v in published.items()}
    assert CONFIG["vit"] == as_lists
    defaults = PrimusConfig()
    for key, value in CONFIG["assumed"]["defaults"].items():
        want = getattr(defaults, key)
        assert (list(want) if isinstance(want, tuple) else want) == value, key


def test_work_of_a_window():
    cfg = reference_config(CONFIG)
    ops, least = work_vit.forward_counts(cfg)
    assert ops / 1e9 == pytest.approx(792.4, abs=0.1)
    att, att_least = work_vit.forward_counts(cfg, "attention")
    assert att / 1e9 == pytest.approx(320.1, abs=0.1)
    # V3 at B=2: 4 N^2 E a window, 12 blocks, 989 TFLOP/s
    assert 2 * att_least / 12 * 1e3 == pytest.approx(0.0539, abs=1e-4)
    vol_ops, vol_least = work_vit.extract_counts(cfg, (192, 192, 192), 64)
    assert vol_ops == 64 * ops and vol_least > 64 * least


def test_reference_imports_nothing_of_the_program():
    path = harness.HERE / "reference" / "primus.py"
    assert _imports(path) <= {"__future__", "contextlib", "math", "typing",
                              "numpy", "torch"}
