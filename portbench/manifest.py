"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names its configuration (the `configs` entry's
`file`) and its traffic (`<bench>/traffic/<traffic>.json`); each metric,
end-to-end or per-layer, is read by `<bench>/metrics/<name>.py`, whose
`read(readings)` returns a number or None. `<bench>` is the first entry
of `paths`. A cell takes 1 or 4 chips; a configuration whose cells take
more than one may hold a `partition` block (`drivers.PARTITION_KEYS`).
`problems()` lists what breaks the manifest's rules that a file can show
by itself.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


class Manifest:
    def __init__(self, root):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.data["paths"][0]

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def metrics(self, section: str, workload: str) -> list:
        """The `section` ("end_to_end" or "per_layer") metrics `workload`
        reports: those that list it, or list no cells."""
        return [m for m in self.data[section]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """The `read` function of `<bench>/metrics/<name>.py`."""
        path = self.bench / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + re.sub(r"\W", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def problems(m: Manifest) -> list:
    """What in the manifest breaks its rules: names and units, files that
    are missing, metrics whose `moves` a listed cell does not report,
    configurations without a cell, cells without an end-to-end metric
    besides `setup_s` or without a per-layer one, cells on other than 1
    or 4 chips, more cells on 4 than max(1, a quarter of the cells), and
    a `partition` block in a configuration no cell on more than one chip
    uses."""
    d = m.data
    out = []
    metrics = d["end_to_end"] + d["per_layer"]
    names = ([c["name"] for c in d["configs"]]
             + [w["name"] for w in d["workloads"]]
             + [w[k] for w in d["workloads"] for k in ("config", "traffic")]
             + [x["name"] for x in metrics]
             + [k for c in d["configs"] for k in c["reduced"]])
    out += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    out += [f"bad unit {x['unit']!r}" for x in metrics
            if not UNIT.match(x["unit"])]
    out += [f"bad source {x['source']!r}" for x in metrics
            if x["source"] not in SOURCES]
    out += [f"end-to-end {x['name']} from {x['source']}"
            for x in d["end_to_end"]
            if x["source"] not in ("host_clock", "device_trace")]
    out += [f"{x['name']}: better {x['better']!r}" for x in metrics
            if x["better"] not in ("lower", "higher")]
    for section in (d["configs"], d["workloads"], metrics):
        seen = [x["name"] for x in section]
        out += [f"duplicate name {n!r}" for n in set(seen)
                if seen.count(n) > 1]
    cells = {w["name"]: w for w in d["workloads"]}
    out += [f"cell {w['name']} on {w['chips']} chips; want 1 or 4"
            for w in d["workloads"] if w["chips"] not in (1, 4)]
    four = sum(1 for w in d["workloads"] if w["chips"] == 4)
    most = max(1, len(cells) // 4)
    if four > most:
        out.append(f"{four} cells on 4 chips; at most {most} of "
                   f"{len(cells)} cells")
    for c in d["configs"]:
        if not (m.root / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
        elif "partition" in m.config(c["name"]) and not any(
                w["config"] == c["name"] and w["chips"] != 1
                for w in d["workloads"]):
            out.append(f"config {c['name']} has a partition block and no "
                       "cell on more than one chip")
        if not any(w["config"] == c["name"] for w in d["workloads"]):
            out.append(f"config {c['name']} has no cell")
    for w in d["workloads"]:
        if not (m.bench / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"traffic {w['traffic']} missing")
        e2e = [x["name"] for x in m.metrics("end_to_end", w["name"])]
        if "setup_s" not in e2e or len(e2e) < 2:
            out.append(f"cell {w['name']} lacks setup_s or another "
                       "end-to-end metric")
        if not m.metrics("per_layer", w["name"]):
            out.append(f"cell {w['name']} has no per-layer metric")
    for x in metrics:
        if not (m.bench / "metrics" / f"{x['name']}.py").is_file():
            out.append(f"reader metrics/{x['name']}.py missing")
        out += [f"{x['name']} lists unknown cell {c}"
                for c in x.get("workloads", []) if c not in cells]
    e2e_names = {x["name"] for x in d["end_to_end"]}
    for x in d["per_layer"]:
        if x["moves"] not in e2e_names:
            out.append(f"{x['name']} moves unknown {x['moves']}")
            continue
        for w in x.get("workloads", list(cells)):
            if x["moves"] not in [e["name"] for e in
                                  m.metrics("end_to_end", w)]:
                out.append(f"{x['name']} in {w}, which does not report "
                           f"{x['moves']}")
    return out
