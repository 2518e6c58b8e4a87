"""One run of one cell: the driver of its traffic mix does the work; this
module gives it a fresh directory, reads the per-layer metrics, and builds
the result line."""

from __future__ import annotations

import dataclasses
import math
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

from perfbench import compare
from perfbench.spec import Cell, readers

#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mcm_tpu")


@dataclasses.dataclass
class Outcome:
    """What a driver hands back after its window and its check."""
    end_to_end: Dict[str, float]
    readings: dict                 # what the per-layer readers read
    checks: Dict[str, dict]        # compare.verdict(...)
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[object] = None  # tracing.Trace of a traced run


def end_to_end(out: Outcome, name: str) -> float:
    """The driver's reading of an end-to-end metric: by its name, or for
    ``<quantity>.<variant>`` (one quantity split by the cells' pace, such
    as ``images_per_s.host_paced``) by its quantity."""
    if name in out.end_to_end:
        return out.end_to_end[name]
    return out.end_to_end[name.split(".")[0]]


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({type(e).__name__})"
    return out.replace("\n", "; ")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """Run the cell once; return the result line's object."""
    driver = cell.module("drivers", cell.traffic["driver"])
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    try:
        out: Outcome = driver.run(cell=cell, seed=seed, seconds=seconds,
                                  trace=trace, device=device, tmp=tmp,
                                  t_start=t_start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        metrics = {}
        for name, reader in readers(cell).items():
            value = reader.read(out.readings, out.trace)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": units[name]}
    else:
        metrics = {m["name"]: {"value": float(end_to_end(out, m["name"])),
                               "unit": m["unit"]} for m in cell.end_to_end}
    import torch
    dev = {"platform": "gpu" if device.startswith("cuda") else device,
           "kind": (torch.cuda.get_device_name(0)
                    if device.startswith("cuda") else device),
           "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": compare.passed(out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                            else None, "limit": v["limit"]}
                        for k, v in out.checks.items()}
    return result


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    import json
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)

