"""BENCHMARK.json against its rules, and a cell, configuration, traffic
mix and per-layer metric added from new files and entries alone."""
import json
import re

import pytest

import portbench_tiny
from portbench.manifest import Manifest, problems

REPO = portbench_tiny.REPO


def test_manifest_keeps_its_rules():
    assert problems(Manifest(REPO)) == []


def test_manifest_shape():
    d = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["command"][:2] == ["python3", "portbench/run.py"]
    assert d["paths"] == ["portbench"]
    assert 1 <= d["run_seconds"] <= 51
    e2e = {x["name"] for x in d["end_to_end"]}
    assert "setup_s" in e2e
    for x in d["end_to_end"]:
        assert 0 < x["bound"] <= 0.25
    for w in d["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for x in d["per_layer"]:
        assert set(x) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if x["name"].endswith("_roofline"):
            assert x["unit"] == "%"
    files = [p.relative_to(REPO).as_posix()
             for p in (REPO / "portbench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts]
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]+", f) for f in files), files


def test_bad_names_and_moves_are_caught(tmp_path):
    root = portbench_tiny.tiny_root(tmp_path)
    d = json.loads((root / "BENCHMARK.json").read_text())
    d["per_layer"][0]["unit"] = "per second"
    d["per_layer"][1]["name"] = "has space"
    d["workloads"][0]["name"] = "a,b"
    d["per_layer"].append(dict(d["per_layer"][-1], name="x.svc",
                               moves="query_p95_ms",
                               workloads=["g500-s24.cohort16"]))
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    got = "\n".join(problems(Manifest(root)))
    for want in ("bad unit 'per second'", "bad name 'has space'",
                 "bad name 'a,b'", "x.svc in g500-s24.cohort16, which does "
                 "not report query_p95_ms"):
        assert want in got, got


def _two_chips(root, d):
    d["workloads"][1]["chips"] = 2
    return "cell g500-s24.cohort16 on 2 chips; want 1 or 4"


def _too_many_on_four(root, d):
    # 5 cells: one may take 4 chips, and the ranked one does
    d["workloads"][0]["chips"] = 4
    return "2 cells on 4 chips; at most 1 of 5 cells"


def _unused_partition_block(root, d):
    f = root / "portbench" / "configs" / "g500-s24.json"
    f.write_text(json.dumps(dict(json.loads(f.read_text()),
                                 partition={"strategy": "specialized"})))
    return ("config g500-s24 has a partition block and no cell on more "
            "than one chip")


@pytest.mark.parametrize("break_rule", [_two_chips, _too_many_on_four,
                                        _unused_partition_block],
                         ids=lambda f: f.__name__.strip("_"))
def test_chip_rules_are_caught(tmp_path, break_rule):
    root = portbench_tiny.tiny_root(tmp_path)
    d = json.loads((root / "BENCHMARK.json").read_text())
    assert problems(Manifest(root)) == []   # a ranked cell is in the rules
    want = break_rule(root, d)
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    assert problems(Manifest(root)) == [want]


def test_cell_added_from_new_files_only(tmp_path):
    root = portbench_tiny.tiny_root(tmp_path)
    bench = root / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "g500-s24.json").read_text())
    cfg["generator"].update(a=0.48, b=0.23, c=0.23)
    (bench / "configs" / "lowskew.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "cohort16.json").read_text())
    traffic["roots_per_query"] = 8
    (bench / "traffic" / "cohort8.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "driver.levels_per_query.py").write_text(
        "def read(r):\n"
        "    if not r.driver_runs:\n"
        "        return None\n"
        "    return sum(d['levels'] for d in r.driver_runs) / "
        "len(r.driver_runs)\n")
    d = json.loads((root / "BENCHMARK.json").read_text())
    d["configs"].append(dict(name="lowskew", source="Graph500 generator at "
                             "A/B/C 0.48/0.23/0.23", reduced=["scale"],
                             file="portbench/configs/lowskew.json",
                             why="less skew"))
    d["workloads"].append(dict(name="lowskew.cohort8", config="lowskew",
                               traffic="cohort8", chips=1, why="test"))
    for x in d["end_to_end"] + d["per_layer"]:
        if "g500-s24.cohort16" in x.get("workloads", []):
            x["workloads"].append("lowskew.cohort8")
    d["per_layer"].append(dict(name="driver.levels_per_query", unit="levels",
                               better="lower", source="program_span",
                               layer="level driver", moves="gteps",
                               workloads=["lowskew.cohort8"]))
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    assert problems(Manifest(root)) == []
    assert all(p.read_bytes() == b for p, b in before.items())
    out = portbench_tiny.run_cell(root, "lowskew.cohort8", trace=True)
    assert out["correct"]
    assert out["metrics"]["driver.levels_per_query"]["value"] > 1
    assert out["metrics"]["driver.levels_per_query"]["unit"] == "levels"
    out = portbench_tiny.run_cell(root, "lowskew.cohort8")
    assert out["correct"] and out["metrics"]["gteps"]["value"] > 0
