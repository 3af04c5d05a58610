"""Runs one cell of the port's benchmark once and prints its result as the
last line of standard output:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json.  Everything a cell
is made of is found by name: its entry in BENCHMARK.json names its
configuration (benchmark/configs/<config>.json, the sizes) and its
traffic mix (benchmark/mixes/<mix>.json, whose "loop" names the general
loop in benchmark/loops/ that reads it); benchmark/workloads/<cell>.json
holds the limits of the numbers that decide `correct`; each per-layer
metric is read by benchmark/metrics/<metric>.py.  With --trace 0 the result holds
the cell's end-to-end metrics, with --trace 1 its per-layer metrics.

A run needs the cards the cell asks for, and fails without a result if
the port or anything it loaded pulled in JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cfen_vit_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (the part before the first dot)
    is, as a whole, one of FORBIDDEN."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One entry of BENCHMARK.json's workloads, with what it names."""

    def __init__(self, name: str, manifest: dict):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.name, self.entry = name, cells[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config = load_json(ROOT / configs[self.entry["config"]]["file"])
        self.mix = load_json(HERE / "mixes" / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m["workloads"]]

    def loop(self):
        return importlib.import_module(f"benchmark.loops.{self.mix['loop']}")


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0) -> dict:
    """The result object of one run (everything but the chip check and the
    JAX check, which `main` makes)."""
    from . import check, trace as tr
    r = cell.loop().run(cell.config, cell.mix, seed, seconds, trace, device, t0)
    correct, numbers = check.verdict(r["checks"], cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m["name"])(r["summary"], r["work"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": r["values"][m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_kind(device), "count": 1,
           "memory_peak_bytes": r["memory_peak_bytes"]}
    out = {"correct": bool(correct and r["failed"] == 0),
           "attempted": r["attempted"], "failed": r["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        s = r["summary"]
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        out["breakdown"] = tr.breakdown(s)
    out["checks"] = numbers
    return out


def _device_kind(device) -> str:
    import torch
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(args.workload, manifest)
    import torch
    chips = cell.entry.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {cell.name} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: the port must not load JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for name, n in out["checks"].items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
