"""The decider for the H2D concurrency question: serial against 4 streams,
A/B in alternating order.

    python -m mcm_tpu_torch.tools.h2d_probe2 [--device cuda|cpu]

The port of ``tools/h2d_probe2.py``: small adjacent cells of CELL distinct
77 MB buffers, ROUNDS rounds, each round one serial cell and one 4-way cell
(four threads, each on ``h2d_probe``'s :class:`Lane`: a stream and a
device buffer made once; the serial cell takes the first), the order of
the two alternating round by round (S,C / C,S / …), and the verdict read
from the distribution of the per-round ratios serial / concurrent: the
median above 1.15 is a win.  Prints a line a round and one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, List, Optional

import numpy as np

from mcm_tpu_torch.tools import h2d_probe

CELL = 4
ROUNDS = 8
WAYS = 4
WIN_MEDIAN = 1.15


def run_rounds(serial: Callable[[], float], concurrent: Callable[[], float],
               rounds: int) -> List[dict]:
    """``rounds`` A/B rounds, serial first in the even ones; each round's
    walls, order and ratio serial / concurrent (> 1: concurrency faster)."""
    out = []
    for rnd in range(rounds):
        if rnd % 2 == 0:
            ts, tc = serial(), concurrent()
        else:
            tc, ts = concurrent(), serial()
        out.append({"order": "S,C" if rnd % 2 == 0 else "C,S",
                    "serial_s": ts, "concurrent_s": tc, "ratio": ts / tc})
    return out


def verdict(ratios) -> str:
    return ("CONCURRENCY WINS" if float(np.median(ratios)) > WIN_MEDIAN
            else "no robust win — keep the serial put")


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    _, bufs, lanes = h2d_probe.setup(args.device, CELL, seed=11, ways=WAYS)
    mb = CELL * h2d_probe.buffer_bytes() / 1e6
    rounds = run_rounds(lambda: h2d_probe.run_serial(lanes[0], bufs),
                        lambda: h2d_probe.run_concurrent(lanes, bufs), ROUNDS)
    for rnd, r in enumerate(rounds):
        print(f"r{rnd}: serial {mb / r['serial_s']:8.1f} MB/s  "
              f"conc{WAYS} {mb / r['concurrent_s']:8.1f} MB/s  "
              f"ratio {r['ratio']:5.2f}  (order {r['order']})", flush=True)
    ratios = np.array([r["ratio"] for r in rounds])
    print(f"\nratio conc{WAYS}/serial: median {np.median(ratios):.2f}  "
          f"mean {ratios.mean():.2f}  min {ratios.min():.2f}  "
          f"max {ratios.max():.2f}", flush=True)
    print("verdict: " + verdict(ratios), flush=True)
    row = {"tool": "h2d_probe2", "device": args.device, "cell": CELL,
           "ways": WAYS, "buffer_bytes": h2d_probe.buffer_bytes(),
           "rounds": [dict(r, serial_MB_per_s=mb / r["serial_s"],
                           concurrent_MB_per_s=mb / r["concurrent_s"])
                      for r in rounds],
           "ratio_median": float(np.median(ratios)),
           "ratio_mean": float(ratios.mean()),
           "ratio_min": float(ratios.min()), "ratio_max": float(ratios.max()),
           "serial_img_per_s_median": float(np.median(
               [CELL * h2d_probe.B / r["serial_s"] for r in rounds])),
           "verdict": verdict(ratios)}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
