"""The harness: found by name, the contract's names and links, the command
without a card."""
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

import harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_bench_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in SOURCES for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in BENCH["end_to_end"])
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(m["unit"] == "%" for m in metrics
               if m["name"].endswith("_roofline"))


def test_bench_files_are_named_from_name_characters():
    for path in (ROOT / "bench").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"[A-Za-z0-9_.\-/]+$", rel), rel


def test_bench_each_per_layer_metric_moves_one_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert isinstance(m["moves"], str) and m["moves"] in e2e, m["name"]
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"]
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
        layers.setdefault(m["layer"], []).append(m["name"])


def test_bench_every_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(BENCH, w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert w["chips"] in (1, 4)
        assert (ROOT / "bench" / "mixes" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        assert c["file"].startswith("bench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_bench_files_added_under_new_names_are_found(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "bench" / "configs" / "tiny-urand.json").write_text(
        json.dumps({"name": "tiny-urand", "generator": "uniform",
                    "graph_seed": 2, "scale": 6, "edge_factor": 4,
                    "weight_range": [1, 9], "capacity_range": [1, 9]}))
    (tmp_path / "bench" / "mixes" / "tiny-mix.json").write_text(
        json.dumps({"driver": "solo", "kinds": ["WP", "BFS"], "clients": 1,
                    "engine": "cuda", "warmup_per_kind": 1,
                    "root_pool": 8,
                    "check_per_kind": 3}))
    (tmp_path / "bench" / "metrics" / "answers_seen.py").write_text(
        "def read(run):\n    return len(run.queries)\n")
    bench = {"configs": [{"name": "tiny-urand",
                          "file": "bench/configs/tiny-urand.json"}],
             "workloads": [{"name": "tiny-cell", "config": "tiny-urand",
                            "traffic": "tiny-mix", "chips": 1}],
             "end_to_end": [{"name": "answers_seen", "unit": "queries"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "iters_per_query", "unit": "iters",
                            "workloads": ["tiny-cell"]},
                           {"name": "queries_per_launch",
                            "unit": "queries", "workloads": ["other"]}]}
    cell = harness.load_cell(bench, "tiny-cell", tmp_path)
    assert cell.mix["kinds"] == ["WP", "BFS"]
    assert [m["name"] for m in cell.per_layer] == ["iters_per_query"]
    run = harness.setup(cell, 11, "cpu", time.perf_counter())
    harness.window(run, 2.0, trace=False)
    harness.free_program(run)
    harness.check(run)
    assert run.check == {"wrong_vertices": 0, "unanswered": 0}
    got = harness.metrics(run, trace=False)
    assert got["answers_seen"]["value"] == len(run.queries) > 0
    assert got["setup_s"]["value"] > 0
    assert set(harness.metrics(run, trace=True)) == {"iters_per_query"}
    assert {q.kind for q in run.queries} == {"WP", "BFS"}


def test_bench_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "urand22-serve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA card" in p.stderr


def test_bench_command_fails_without_the_program(tmp_path):
    (tmp_path / "bench").mkdir()
    shutil.copytree(ROOT / "bench", tmp_path / "bench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "kron16-serve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("value,ok", [(0, True), (1, False)])
def test_bench_verdict_holds_each_number_to_its_limit(value, ok):
    from reference import compare
    assert compare.LIMITS == {"wrong_vertices": 0, "unanswered": 0}
    assert compare.verdict({"wrong_vertices": value, "unanswered": 0}) is ok
    assert compare.verdict({"wrong_vertices": 0, "unanswered": value}) is ok


def test_bench_traced_window_on_the_cpu_reads_no_device_metric(capsys):
    import run as command
    cell = harness.load_cell(BENCH, "kron16-serve")
    run = harness.setup(cell, 7, "cpu", time.perf_counter(), {"scale": 7})
    harness.window(run, 0.5, trace=True)
    harness.free_program(run)
    harness.check(run)
    assert run.trace["steps"] > 0 and run.trace["busy_s"] == 0
    assert run.trace["answered"] and run.needed_bytes > 0
    got = harness.metrics(run, trace=True)
    # device readings come only from a card: none is written here
    assert not {"idle_share", "device_roofline", "sweep_ms_per_step",
                "host_gap_ms_per_step", "graph_resident_gib"} & set(got)
    assert {"queries_per_launch", "slot_occupancy", "iters_per_query",
            "graph_build_s"} <= set(got)
    run.device_name = "cpu"
    out = command.result_line(run, got, True, 1)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "check"]
    command.report(run, out)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2:] == ["check wrong_vertices 0 limit 0",
                        "check unanswered 0 limit 0"]
