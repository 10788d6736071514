"""The benchmark's core: find a cell by name, run it, build the result.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric sits in a file of its own, found by name under the
benchmark's directory (`portbench/` beside `BENCHMARK.json`):

- `workloads/<cell>.json`: config, traffic, chips, why, and the limits of
  the numbers that decide `correct`;
- `configs/<config>.json`: the sizes as run, `source`, `reduced`,
  `assumed`, and the `system` adapter (`systems/<system>.py`);
- `traffic/<traffic>.json`: the parameters of one mix and its driver
  (`drivers/<driver>.py`);
- `metrics/<measure>.py`: a reader, `read(run) -> float | None`, of
  every per-layer metric named `<measure>` or `<measure>.<cells>`
  (`device_idle.solve` and `device_idle.apply` share
  `metrics/device_idle.py`).

A driver module has `prepare(run)` (set-up and warm-up), `window(run)`
(the closed loop for `run.seconds`), `request(run, i)` (one request, for
the traced sub-window), `end_to_end(run) -> dict`, `release(run)` (frees
the program's state once its peak memory is read) and
`check(run) -> (checks, failed)`, `checks` mapping a short name to
(number, limit).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
ROOT = PKG_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "butterfly_tpu")


class BenchError(Exception):
    """A cell that cannot be run as its files describe it."""


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise BenchError(f"missing file {path}") from None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list   # BENCHMARK.json's metric entries for this cell
    per_layer: list


class Bench:
    """`BENCHMARK.json` under `root` and the files it names, all under
    `root/portbench/`."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.manifest = load_json(self.root / "BENCHMARK.json")

    def find(self, kind: str, filename: str) -> Path:
        path = self.dir / kind / filename
        if not path.is_file():
            raise BenchError(f"no {path}")
        return path

    def _entry(self, key: str, name: str) -> dict:
        for e in self.manifest[key]:
            if e["name"] == name:
                return e
        raise BenchError(f"BENCHMARK.json has no {key} entry {name!r}")

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        wfile = load_json(self.find("workloads", f"{name}.json"))
        for key in ("config", "traffic", "chips"):
            if wfile.get(key) != w[key]:
                raise BenchError(f"workloads/{name}.json {key} "
                                 f"{wfile.get(key)!r} != BENCHMARK.json's "
                                 f"{w[key]!r}")
        rel = self._entry("configs", w["config"])["file"]
        config = load_json(self.root / rel)
        traffic = load_json(self.find("traffic", f"{w['traffic']}.json"))
        e2e = [m for m in self.manifest["end_to_end"]
               if name in m.get("workloads", [name])]
        names = {m["name"] for m in e2e}
        layer = [m for m in self.manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
        return Cell(name, int(w["chips"]), wfile, config, traffic, e2e,
                    layer)

    def module(self, kind: str, name: str):
        """`portbench/<kind>/<name>.py`, loaded by its path."""
        path = self.find(kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclasses.dataclass
class Run:
    """One run's state, handed to the driver and the metric readers."""

    bench: Bench
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    setup_s: float = None
    window_s: float = None
    system: object = None
    traced: object = None        # trace.Trace of the traced sub-window
    state: dict = dataclasses.field(default_factory=dict)

    def mark(self, name: str) -> None:
        """Seconds from the process's start to a step of set-up."""
        self.state.setdefault("marks", {})[name] = (time.perf_counter()
                                                    - self.t_start)

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: `butterfly_tpu_torch` is not
    `butterfly_tpu`)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(run: Run, peak: int) -> dict:
    if run.on_card:
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(run.device),
                "count": run.cell.chips, "memory_peak_bytes": int(peak)}
    return {"platform": run.device.type, "kind": run.device.type,
            "count": 1, "memory_peak_bytes": 0}


def execute(bench: Bench, cell_name: str, seed: int, seconds: float,
            trace: bool, device, t_start: float) -> dict:
    """Set up, warm up, measure, trace (with `trace`), check: the result
    object (the last line's content). The caller has checked the
    device."""
    from portbench import trace as tracing

    cell = bench.cell(cell_name)
    run = Run(bench, cell, int(seed), float(seconds), bool(trace),
              torch.device(device), t_start)
    driver = bench.module("drivers", cell.traffic["driver"])
    run.mark("start_prepare")
    driver.prepare(run)
    run.sync()
    run.setup_s = time.perf_counter() - t_start
    driver.window(run)
    card = gpu_state() if run.on_card else None

    layer_values = {}
    if run.trace:
        count = int(cell.traffic["trace_requests"])
        run.traced = tracing.traced(
            lambda i: driver.request(run, i), count,
            bench.root / "build" / "portbench" / f"trace_{cell.name}.json",
            getattr(run.system, "spans", {}))
        for m in cell.per_layer:
            measure = m["name"].split(".")[0]
            value = bench.module("metrics", measure).read(run)
            if value is not None:
                layer_values[m["name"]] = float(value)
    run.sync()
    peak = torch.cuda.max_memory_allocated(run.device) if run.on_card else 0
    setup = dict(run.system.timings, **run.state.get("marks", {}))
    driver.release(run)
    run.system = None
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    checks, failed = driver.check(run)

    if run.trace:
        metrics = {m["name"]: {"value": layer_values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in layer_values}
    else:
        values = driver.end_to_end(run)
        values["setup_s"] = run.setup_s
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in values]
        if missing:
            raise BenchError(f"the driver gave no {missing}")
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": int(run.state["attempted"]), "failed": int(failed),
           "metrics": metrics, "device": device_info(run, peak)}
    if run.trace:
        out["device"].update(busy_s=run.traced.busy_s,
                             window_s=run.traced.window_s)
        out["breakdown"] = {"device_ops": run.traced.device_ops,
                            "idle_gaps": run.traced.idle_gaps}
    out["setup"] = setup
    if "roofline" in run.state:
        out["roofline"] = run.state["roofline"]
    if card is not None:
        out["card"] = card
    out["checks"] = {k: {"value": float(v), "limit": float(lim)}
                     for k, (v, lim) in checks.items()}
    return out


GPU_QUERY = ("power.limit", "power.draw", "clocks.sm", "temperature.gpu")


def gpu_state() -> dict:
    """The card's power limit and draw (W), SM clock (MHz) and temperature
    (C) from nvidia-smi, read as the window closes; {} where it cannot be
    read."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "-i", str(torch.cuda.current_device()),
             f"--query-gpu={','.join(GPU_QUERY)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return dict(zip(GPU_QUERY, (float(v) for v in
                                    proc.stdout.split(","))))
    except (OSError, subprocess.SubprocessError, ValueError):
        return {}
