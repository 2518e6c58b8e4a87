"""Timing shared by the attention probe tools.

A row's time is that of one application of ``step`` inside a CHAIN of
dependent applications (``x_{i+1} = step(x_i)``), so that no application
can start before the one it reads has finished, as the JAX tools chain them
inside one jit.  On the card CUDA events bracket the chain; on the CPU
``time.perf_counter`` does, and the numbers are CPU numbers.  The best of
OUTER chains, after one chain of warm-up (which also builds the kernels),
divided by CHAIN is the row.  The tools read CHAIN and OUTER when they
time, so a caller may cut them.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Union

import torch

CHAIN = 20
OUTER = 3

#: row name → seconds per application, or "FAILED: ..." for a row that raised
Rows = Dict[str, Union[float, str]]


def time_chain(step: Callable[[torch.Tensor], torch.Tensor],
               x: torch.Tensor) -> float:
    """Seconds per application of ``step``, best of OUTER chains of CHAIN."""
    def chain():
        y = x
        for _ in range(CHAIN):
            y = step(y).to(x.dtype)
        return y

    chain()
    best = float("inf")
    for _ in range(OUTER):
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chain()
            seconds = time.perf_counter() - t0
        best = min(best, seconds / CHAIN)
    return best


def measure(rows: Rows, name: str, step, x: torch.Tensor, flops: float,
            width: int = 12) -> None:
    """Time ``step`` from ``x`` into ``rows[name]`` and print the row as the
    JAX tools do (``name: ms (TFLOP/s)``); a row that raises is printed and
    recorded as FAILED, and the tool's exit status says so."""
    try:
        val: Union[float, str] = time_chain(step, x)
    except Exception as e:  # noqa: BLE001 — report the row, exit non-zero
        val = f"FAILED: {type(e).__name__}: {str(e)[:300]}"
    rows[name] = val
    if isinstance(val, float):
        print(f"{name:{width}s}: {val * 1000:8.2f} ms  "
              f"({flops / val / 1e12:6.1f} TFLOP/s)", flush=True)
    else:
        print(f"{name:{width}s}: {val}", flush=True)


def failed(rows: Rows) -> List[str]:
    return [name for name, val in rows.items() if not isinstance(val, float)]


def cli(main: Callable[[str], Rows], argv: Optional[List[str]] = None) -> int:
    """``[--device cuda|cpu]`` → ``main(device)``; 1 if any row failed."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    return 1 if failed(main(args.device)) else 0
