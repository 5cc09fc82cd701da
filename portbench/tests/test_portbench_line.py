"""The result line, BENCHMARK.json's names and units, and the import
rules, on the CPU."""

import ast
import json
import re
import sys
from pathlib import Path

import pytest

from portbench import cell
from portbench.tests.conftest import BENCH, PROGRAM, small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_the_last_line(workload):
    line = cell.run_cell(workload, 2**31 + 1, 0.0, False, "cpu",
                         corpus_override=small(workload),
                         program_override=PROGRAM)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    e2e = {m["name"] for m in cell.load_cell(workload)["end_to_end"]}
    assert set(line["metrics"]) == e2e
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    json.dumps(line)


def test_the_traced_line(workload):
    line = cell.run_cell(workload, 5, 0.0, True, "cpu",
                         corpus_override=small(workload),
                         program_override=PROGRAM)
    assert line["correct"] is True
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    # Host-clock readers read on the CPU too; the roofline finds no kernel.
    assert any(k.startswith("dispatch_ms.") for k in line["metrics"])
    assert not any(k.startswith("tokenize_stream_roofline")
                   for k in line["metrics"])
    assert list(line)[-1] == "checks"


def test_names_units_and_files():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + [w["name"] for w in
                                            BENCH["workloads"]] \
        + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert (cell.HERE / "metrics" / f"{m['name'].split('.')[0]}.py") \
            .is_file()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"]
    for w in BENCH["workloads"]:
        traffic = cell.load_json(
            cell.HERE / "traffic" / f"{w['traffic']}.json")
        assert callable(cell.load("loops", traffic["loop"]).window)
        assert len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = cell.load_json(cell.ROOT / c["file"])
        assert callable(cell.load("jobs", cfg["job"]).run)
        ref = cell.load("reference", cfg["job"])
        assert {"expected", "readings", "LIMITS", "CONTROLS"} <= set(vars(ref))
        assert (cell.HERE / "corpus" / f"{cfg['corpus']['kind']}.py").is_file()
    assert BENCH["paths"] == ["portbench"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_no_reference_package_no_repo_tools():
    files = sorted(cell.HERE.rglob("*.py"))
    assert files
    for path in files:
        names = _imports(path)
        assert not names & {"jax", "jaxlib", "flax", "mapreduce_tpu",
                            "bench", "tools"}, path
    for folder in ("reference", "corpus"):
        for path in (cell.HERE / folder).glob("*.py"):
            assert "mapreduce_tpu_torch" not in _imports(path), path


def test_the_run_time_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mapreduce_tpu_torch_x", sys)
    assert "mapreduce_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mapreduce_tpu.models", sys)
    assert cell.forbidden_modules() == ["mapreduce_tpu"]


@pytest.mark.cuda
def test_a_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    line = cell.run_cell(workload, 11, 0.0, False, "cuda",
                         corpus_override=small(workload))
    assert line["correct"] is True
