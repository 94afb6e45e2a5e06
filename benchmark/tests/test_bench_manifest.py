"""BENCHMARK.json against the benchmark's contract, and the data-driven
layout: every name resolves to its files."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_entry_keys(manifest):
    assert set(manifest) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for part, keys in KEYS.items():
        for e in manifest[part]:
            extra = {"workloads"} if part in ("end_to_end",
                                              "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (part, e["name"])


def test_command_and_paths(manifest):
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in manifest["paths"])
            assert (ROOT / w).is_file()
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_units_and_lines(manifest):
    names = []
    for part in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[part]:
            assert NAME.match(e["name"]), e["name"]
            names.append((part, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert one_line(e[key]), (e["name"], key)
    for part in ("configs", "workloads"):
        ns = [n for p, n in names if p == part]
        assert len(ns) == len(set(ns))
    metrics = [n for p, n in names if p in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_configs_files_and_reductions(manifest):
    files = set()
    for c in manifest["configs"]:
        f = c["file"]
        assert f.startswith("benchmark/") and f not in files
        files.add(f)
        data = json.loads((ROOT / f).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] == []
        assert data["assumed"]
        assert any(w["config"] == c["name"] for w in manifest["workloads"])


def test_cells_resolve_to_their_files(manifest):
    pairs = set()
    configs = {c["name"] for c in manifest["configs"]}
    four = sum(w["chips"] == 4 for w in manifest["workloads"])
    assert four <= max(1, len(manifest["workloads"]) // 4)
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "traffic"
                / f"{mix['generator']}.py").is_file()
        limits = json.loads((ROOT / "benchmark" / "cells"
                             / f"{w['name']}.json").read_text())["limits"]
        assert set(limits) == {"det_gap", "res_gap"}


def test_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in manifest["workloads"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        # each cell the metric names reports the metric it moves
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for c in cells:
        assert sum(c in m.get("workloads", cells)
                   for m in e2e.values()) >= 2
        assert any(c in m.get("workloads", cells)
                   for m in manifest["per_layer"])


def test_files_under_paths_are_named_from_names():
    allowed = re.compile(r"^[A-Za-z0-9_./-]+$")
    for f in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in f.parts:
            continue
        assert allowed.match(str(f.relative_to(ROOT))), f
