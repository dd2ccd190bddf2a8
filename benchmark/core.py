"""The harness: one run of one cell.

``BENCHMARK.json`` names the cell's configuration and traffic; each is a
file found by its name (``configs/<config>.json``, ``traffic/<traffic>.json``).
The traffic's ``driver`` names the module under ``drivers/`` that runs a
unit of work on the program and checks it against the plain reference.
Every metric is a reader of its own, ``metrics/<name>.py``, whose ``read``
takes the :class:`Run` and returns a number, or None when it finds nothing
to read.

A run: the card checked, the driver's set-up and one warm unit of the
cell's own shapes (``setup_s`` ends here), then units one after another
until ``--seconds`` have passed (under ``torch.profiler`` with ``--trace
1``), then the peak memory, the program's state freed, the check, the
module guard, and one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    port's kernels build into ``build/torch_kernels`` there by
    themselves."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(spec: dict, workload: str):
    """The cell's entry, its configuration and its traffic parameters."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def cell_metrics(spec: dict, cell: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics that ``cell`` reports: those
    that list it, and those without a list (a per-layer one then goes with
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec.get("per_layer", [])
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a run hands the metric readers."""
    cell: str
    unit_items: str
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    items: int = 0
    counters: dict = field(default_factory=dict)
    trace: Optional[object] = None


def measure(driver, seconds: float, trace: bool):
    """Units one after another until ``seconds`` have passed; returns
    (units, items, window seconds, trace or None)."""
    import torch
    from benchmark import tracing

    def window():
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            driver.start()
            t0 = time.perf_counter()
            units = items = 0
            while True:
                with torch.profiler.record_function("bench.unit"):
                    items += driver.unit(units)
                units += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            return units, items, time.perf_counter() - t0

    if trace:
        (units, items, window_s), tr = tracing.traced(window)
    else:
        (units, items, window_s), tr = window(), None
    return units, items, window_s, tr


def run_cell(spec: dict, cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` (its entry in ``spec``, with its configuration
    and traffic); returns the result line as a dict (its ``compared``
    entry last)."""
    import torch

    workload = cell["name"]
    driver_cls = importlib.import_module(f"benchmark.drivers.{traffic['driver']}").Driver
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = driver_cls(cfg, traffic, seed, device)
    driver.warm()
    run = Run(cell=workload, unit_items=driver.unit_items)
    run.setup_s = time.time() - t_start
    run.units, run.items, run.window_s, run.trace = measure(driver, seconds, trace)
    run.counters = driver.counters()
    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    driver.release()
    compared = driver.check(run.units)
    limits = traffic["limits"]
    correct = all(compared[k] <= limits[k] for k in limits)

    metrics = cell_metrics(spec, workload)["per_layer" if trace else "end_to_end"]
    values = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": run.items, "failed": 0, "metrics": values,
           "device": dev}
    if trace and run.trace is not None:
        w0, w1 = run.trace.window or (0.0, run.window_s)
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = w1 - w0
        out["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["compared"] = {k: {"value": compared[k], "limit": limits[k]} for k in limits}
    return out


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell, cfg, traffic = cell_files(spec, args.workload)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = run_cell(spec, cell, cfg, traffic, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    from benchmark.guard import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"bench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
