"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run makes its inputs and weights from
``--seed``, sets up and warms the cell's own shapes (``setup_s``: process
start to the window's start), measures for ``--seconds`` (``--trace 1``:
under the profiler, reporting the per-layer metrics instead of the
end-to-end ones), reads the peak device memory, frees the port's state,
compares what the timed path produced with the plain reference, and prints
each compared number beside its limit: as the last lines on standard error,
and as the ``checks`` key, last in the one JSON line it prints last on
standard output.  It exits non-zero with no result line when CUDA or the
cell's cards are missing, when the port is not in the checkout, or when a
JAX module is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import guard, manifest  # noqa: E402
from .trace import DeviceTrace, Spans, breakdown  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (``/proc``), else since import."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T0


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Result:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    readings: Dict = field(default_factory=dict)


@dataclass
class Context:
    """What a generator gets: the cell, its files' contents, the run's flags, a
    scratch directory under ``TMPDIR``, the spans and the device trace."""
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    tracing: bool
    workdir: str
    device: str = "cuda"
    spans: Spans = None
    trace: Optional[DeviceTrace] = None
    setup_s: Optional[float] = None

    def window_started(self) -> None:
        self.setup_s = process_age()

    @property
    def devices(self) -> List[str]:
        if self.device == "cpu":
            return ["cpu"]
        return [f"cuda:{i}" for i in range(int(self.cell["chips"]))]


def load_reader(metric: str):
    spec = importlib.util.spec_from_file_location(f"portbench_reader_{metric}",
                                                  manifest.reader_path(metric))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer_values(bench: Dict, cell_name: str, reduced: Optional[Dict], readings: Dict,
                     device_name: str) -> Dict[str, Dict]:
    from .costs.peaks import peaks

    inputs = dict(readings, trace=reduced, peaks=peaks(device_name))
    out = {}
    for m in manifest.per_layer(bench, cell_name):
        value = load_reader(m["name"])(inputs)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(ctx: Context) -> Result:
    generator = importlib.import_module(f"portbench.generators.{ctx.traffic['generator']}")
    return generator.run(ctx)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ["USE_FLAX"] = "0"

    root = os.getcwd()
    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload)
    entry = manifest.config_entry(bench, cell["config"])
    with open(os.path.join(root, entry["file"]), encoding="utf-8") as fh:
        config = json.load(fh)
    with open(manifest.traffic_path(cell["traffic"]), encoding="utf-8") as fh:
        traffic = json.load(fh)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); {count} visible",
              file=sys.stderr)
        return 2
    try:
        import mmgclip_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the port is not in this checkout: {exc}", file=sys.stderr)
        return 2

    workdir = tempfile.mkdtemp(prefix="portbench-")
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, tracing=bool(args.trace), workdir=workdir,
                  spans=Spans(),
                  trace=DeviceTrace() if args.trace else None)
    try:
        result = run_cell(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    loaded = guard.forbidden_loaded(sys.modules)
    if loaded:
        print(f"portbench: JAX modules loaded in the benchmark process: {loaded}", file=sys.stderr)
        return 3

    device_name = torch.cuda.get_device_name(0)
    line = {"correct": all(c.ok for c in result.checks), "attempted": result.attempted,
            "failed": result.failed}
    device = {"platform": "gpu", "kind": device_name, "count": int(cell["chips"]),
              "memory_peak_bytes": int(result.memory_peak_bytes)}
    if args.trace:
        reduced = ctx.trace.reduce(ctx.spans)
        line["metrics"] = per_layer_values(bench, cell["name"], reduced, result.readings,
                                           device_name)
        if reduced is not None:
            device.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
            line["breakdown"] = breakdown(reduced)
    else:
        e2e = dict(result.e2e, setup_s=ctx.setup_s)
        units = {m["name"]: m["unit"] for m in manifest.end_to_end(bench, cell["name"])}
        line["metrics"] = {k: {"value": float(e2e[k]), "unit": u} for k, u in units.items()}
    line["device"] = device
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in result.checks}
    sys.stdout.flush()
    totals = {}
    for name, t0, t1 in ctx.spans.records:
        totals[name] = totals.get(name, 0.0) + t1 - t0
    print("spans: " + ", ".join(f"{k} {v:.3f} s" for k, v in totals.items()), file=sys.stderr)
    for c in result.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
