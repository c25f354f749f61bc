"""BENCHMARK.json: loading, validation, and what a cell is made of.

A cell (an entry of ``workloads``) names a configuration (a file of its
own, ``configs[].file``), a traffic mix (``benchmark/traffic/<name>.json``)
and the chips it needs.  A configuration's ``reference`` key names its
reference module (benchmark/compare.py says what one gives).  A mix's
``streams`` (default 1) is how many streams the cell runs in lock-step
through the program's multi-sequence mode, a closed loop only.  Its
end-to-end metrics are the ``end_to_end`` entries without a ``workloads``
key or with the cell in it; its per-layer metrics are the ``per_layer``
entries that list it, or that list no cells and move one of its end-to-end
metrics.  Each per-layer metric is read by
``benchmark/layer_metrics/<name>.py``.  Everything is found by name, so a
cell, a mix or a metric is added by adding files and entries.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head")
# What the harness core computes end to end, by the loop of the cell's traffic.
E2E_BY_LOOP = {"closed": {"fps", "setup_s"},
               "open": {"latency_p50_ms", "latency_p95_ms", "setup_s"}}


class SpecError(ValueError):
    pass


def load(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _text(value, what: str) -> None:
    if not isinstance(value, str) or not 1 <= len(value) <= 200 or "\n" in value \
            or "\t" in value:
        raise SpecError(f"{what}: 1 to 200 characters on one line, no tab")


def _name(value, what: str) -> None:
    if not isinstance(value, str) or not NAME.match(value):
        raise SpecError(f"{what} {value!r} is not a name")


def _keys(entry: dict, allowed: set, what: str, optional: set = frozenset()) -> None:
    missing, extra = allowed - set(entry), set(entry) - allowed - set(optional)
    if missing or extra:
        raise SpecError(f"{what}: missing {sorted(missing)}, unknown {sorted(extra)}")


def _under(path: str, paths: list) -> bool:
    return any(Path(path).parts[:len(Path(p).parts)] == Path(p).parts for p in paths)


def traffic_path(root: Path, traffic: str) -> Path:
    return root / "benchmark" / "traffic" / f"{traffic}.json"


def reader_path(root: Path, metric: str) -> Path:
    return root / "benchmark" / "layer_metrics" / f"{metric}.py"


def load_traffic(root: Path, traffic: str) -> dict:
    with open(traffic_path(root, traffic)) as f:
        return json.load(f)


def streams_of(traffic: dict) -> int:
    """The mix's stream count: a whole number >= 1 (default 1); more than
    one only in a closed loop, whose rounds the multi-sequence mode takes
    as fast as it can (an open loop's due times are one camera's)."""
    b = traffic.get("streams", 1)
    if isinstance(b, bool) or not isinstance(b, int) or b < 1:
        raise SpecError(f"streams {b!r}: a whole number >= 1")
    if b > 1 and traffic.get("loop") != "closed":
        raise SpecError(f"streams {b}: several streams run in a closed loop only")
    return b


def load_config(root: Path, spec: dict, name: str) -> dict:
    entry = next(c for c in spec["configs"] if c["name"] == name)
    with open(root / entry["file"]) as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SpecError(f"no workload {workload!r} in BENCHMARK.json")


def end_to_end_of(spec: dict, workload: str) -> list[dict]:
    return [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]


def per_layer_of(spec: dict, workload: str) -> list[dict]:
    reported = {m["name"] for m in end_to_end_of(spec, workload)}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def validate(spec: dict, root: Path) -> None:
    """Raise SpecError where BENCHMARK.json breaks the benchmark's contract."""
    _keys(spec, TOP_KEYS, "BENCHMARK.json")
    cmd, paths = spec["command"], spec["paths"]
    if not isinstance(cmd, list) or not 1 <= len(cmd) <= 32:
        raise SpecError("command: a list of 1 to 32 strings")
    for word in cmd:
        _text(word, "command word")
        if word.startswith("/") or ".." in word.split("/"):
            raise SpecError(f"command word {word!r} leaves the checkout")
    if not isinstance(paths, list) or not 1 <= len(paths) <= 16:
        raise SpecError("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            raise SpecError(f"path {p!r}")
        if not (root / p).is_dir():
            raise SpecError(f"path {p!r} is not a directory")
    rs = spec["run_seconds"]
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        raise SpecError("run_seconds: a whole number from 1 to 51")

    names: set[str] = set()

    def unique(n, what):
        _name(n, what)
        if n in names:
            raise SpecError(f"{what} {n!r} is used twice")
        names.add(n)

    configs = spec["configs"]
    if not 1 <= len(configs) <= 24:
        raise SpecError("configs: 1 to 24")
    files = set()
    for c in configs:
        _keys(c, CONFIG_KEYS, f"config {c.get('name')}")
        unique(c["name"], "config")
        _text(c["source"], "config source")
        _text(c["why"], "config why")
        if not _under(c["file"], paths):
            raise SpecError(f"config file {c['file']} is not under paths")
        if c["file"] in files or not (root / c["file"]).is_file():
            raise SpecError(f"config file {c['file']} is missing or shared")
        files.add(c["file"])
        with open(root / c["file"]) as f:
            ref = json.load(f).get("reference")
        if not isinstance(ref, str) or not PATH.match(ref) or not ref.endswith(".py") \
                or ".." in ref.split("/") or not _under(ref, paths) or not (root / ref).is_file():
            raise SpecError(f"config {c['name']}: reference {ref!r} is no .py file under paths")
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise SpecError("reduced: a list of at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
            if k.endswith(("_dim", "_rank")) or any(w in k for w in WIDTH_WORDS):
                raise SpecError(f"reduced names a width: {k}")

    cells = spec["workloads"]
    if not 1 <= len(cells) <= 24:
        raise SpecError("workloads: 1 to 24")
    pairs = set()
    used = set()
    for w in cells:
        _keys(w, WORKLOAD_KEYS, f"workload {w.get('name')}")
        unique(w["name"], "workload")
        _name(w["config"], "config")
        _name(w["traffic"], "traffic")
        _text(w["why"], "workload why")
        if w["config"] not in {c["name"] for c in configs}:
            raise SpecError(f"workload {w['name']}: unknown config {w['config']}")
        if not traffic_path(root, w["traffic"]).is_file():
            raise SpecError(f"workload {w['name']}: no traffic file for {w['traffic']}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"workload {w['name']}: chips is 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            raise SpecError(f"workload {w['name']}: the pair appears twice")
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    if used != {c["name"] for c in configs}:
        raise SpecError(f"configs used by no cell: {sorted({c['name'] for c in configs} - used)}")
    if sum(w["chips"] == 4 for w in cells) > max(1, len(cells) // 4):
        raise SpecError("too many four-chip cells")

    e2e, layer = spec["end_to_end"], spec["per_layer"]
    if not 1 <= len(e2e) <= 16 or not 1 <= len(layer) <= 128:
        raise SpecError("end_to_end: 1 to 16 metrics; per_layer: 1 to 128")
    cell_names = {w["name"] for w in cells}
    for m in e2e:
        _keys(m, E2E_KEYS, f"metric {m.get('name')}", {"workloads"})
        unique(m["name"], "metric")
        if m["source"] not in ("host_clock", "device_trace"):
            raise SpecError(f"{m['name']}: an end-to-end metric comes from host_clock or "
                            "device_trace")
        if not isinstance(m["bound"], (int, float)) or not 0.01 <= m["bound"] <= 0.25:
            raise SpecError(f"{m['name']}: bound between 0.01 and 0.25")
    if "setup_s" not in {m["name"] for m in e2e}:
        raise SpecError("setup_s is missing")
    for m in layer:
        _keys(m, LAYER_KEYS, f"metric {m.get('name')}", {"workloads"})
        unique(m["name"], "metric")
        _text(m["layer"], "layer")
        if m["source"] not in ("device_trace", "program_span", "program_counter",
                               "host_clock"):
            raise SpecError(f"{m['name']}: unknown source {m['source']}")
        if m["moves"] not in {e["name"] for e in e2e}:
            raise SpecError(f"{m['name']} moves no end-to-end metric")
        if not reader_path(root, m["name"]).is_file():
            raise SpecError(f"{m['name']}: no reader {reader_path(root, m['name'])}")
    for m in e2e + layer:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher"):
            raise SpecError(f"{m['name']}: unit or better")
        for w in m.get("workloads", []):
            if w not in cell_names:
                raise SpecError(f"{m['name']}: unknown workload {w}")
    for w in cells:
        traffic = load_traffic(root, w["traffic"])
        loop = traffic["loop"]
        try:
            streams_of(traffic)
        except SpecError as e:
            raise SpecError(f"{w['name']}: {e}") from None
        reported = {m["name"] for m in end_to_end_of(spec, w["name"])}
        if not reported <= E2E_BY_LOOP[loop]:
            raise SpecError(f"{w['name']}: a {loop} loop does not give "
                            f"{sorted(reported - E2E_BY_LOOP[loop])}")
        if "setup_s" not in reported or len(reported) < 2:
            raise SpecError(f"{w['name']}: reports setup_s and another end-to-end metric")
        mine = per_layer_of(spec, w["name"])
        if not mine:
            raise SpecError(f"{w['name']}: reports no per-layer metric")
        for m in mine:
            if m["moves"] not in reported:
                raise SpecError(f"{m['name']} moves {m['moves']}, which {w['name']} does "
                                "not report")
