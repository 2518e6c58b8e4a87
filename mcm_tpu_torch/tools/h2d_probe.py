"""Do host→device copies run faster over concurrent streams than one?

    python -m mcm_tpu_torch.tools.h2d_probe [--device cuda|cpu]

The port of ``tools/h2d_probe.py``.  The decode-included e2e pass waits on
copying each 512-image uint8 batch (77 MB) to the card, which the runner
issues one after another; if two or four concurrent streams copied faster,
a pipelined put could raise the e2e ceiling (3129–3177 img/s against a
device rate of 3244 on the H100, ``PERF.md`` §5).

N_BUFFERS distinct uint8 buffers of 512 × 224 × 224 × 3 (no layer can
cache or dedup a copy), pinned on the card's host.  A way is a
:class:`Lane`: a CUDA stream and a device buffer of its own, made once
before any timed window and warmed by one transfer, so no timed copy pays
a device allocation (the caching allocator reuses a block only on the
stream that allocated it: a stream made per call would).  A transfer
copies a buffer into its lane's with ``copy_(..., non_blocking=True)`` and
forces completion by a small reduction on the card read back to the
host, as the JAX tool forces it.  The serial arm is the first lane; the
concurrent arm runs one thread per lane, the buffers dealt round robin.
ROUNDS rounds of serial, 2-way and 4-way in turn (the order fixed within
a round), so a drifting rate cannot pass for a win; each prints MB/s and
the img/s it equals.  ``--device cpu`` copies host to host (the tool's
logic, no measurement).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from mcm_tpu_torch.config import resolve_device

B, S = 512, 224
N_BUFFERS = 8
ROUNDS = 3
WAYS = (2, 4)


def buffer_bytes() -> int:
    return B * S * S * 3


def make_buffers(n: int, seed: int = 7,
                 pin: bool = False) -> List[torch.Tensor]:
    """``n`` distinct uint8 ``[B, S, S, 3]`` buffers (SFC64 fill), pinned
    when ``pin``."""
    gen = np.random.Generator(np.random.SFC64(seed))
    bufs = [torch.from_numpy(gen.integers(0, 256, size=(B, S, S, 3),
                                          dtype=np.uint8))
            for _ in range(n)]
    return [b.pin_memory() for b in bufs] if pin else bufs


class Lane:
    """One way of a transfer: a CUDA stream (on the card) and a device
    buffer shaped like ``like``, both made once and reused by every
    transfer."""

    def __init__(self, like: torch.Tensor, device: torch.device):
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.dst = torch.empty_like(like, device=device)

    def transfer(self, buf: torch.Tensor) -> int:
        """``buf`` into the lane's device buffer on the lane's stream,
        completion forced by a reduction read back to the host."""
        with (torch.cuda.stream(self.stream) if self.stream is not None
              else contextlib.nullcontext()):
            self.dst.copy_(buf, non_blocking=True)
            return int(self.dst.sum(dtype=torch.int64).item())


def run_serial(lane: Lane, buffers: Sequence[torch.Tensor]) -> float:
    t0 = time.perf_counter()
    for b in buffers:
        lane.transfer(b)
    return time.perf_counter() - t0


def run_concurrent(lanes: Sequence[Lane],
                   buffers: Sequence[torch.Tensor]) -> float:
    """Wall of copying ``buffers`` over one thread per lane, the buffers
    dealt round robin."""
    ways = len(lanes)
    chunks = [list(buffers[i::ways]) for i in range(ways)]
    errs = []

    def worker(lane, chunk):
        try:
            for b in chunk:
                lane.transfer(b)
        except Exception as e:  # noqa: BLE001 — raised after the join
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(lane, c))
               for lane, c in zip(lanes, chunks)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return time.perf_counter() - t0


def rates(wall: float, n: int) -> dict:
    """MB/s and the img/s it equals, for ``n`` buffers in ``wall`` s."""
    return {"wall_s": wall, "MB_per_s": n * buffer_bytes() / 1e6 / wall,
            "img_per_s": n * B / wall}


def report(name: str, r: dict) -> None:
    print(f"{name:22s}: {r['wall_s']:6.2f}s  {r['MB_per_s']:8.1f} MB/s  "
          f"({r['img_per_s']:7.1f} img/s equivalent)", flush=True)


def setup(device_name: str, n: int, seed: int, ways: int):
    """(device, buffers, lanes): ``ways`` lanes, each warmed by one
    transfer."""
    dev = resolve_device(device_name)
    bufs = make_buffers(n, seed, pin=dev.type == "cuda")
    lanes = [Lane(bufs[0], dev) for _ in range(ways)]
    for lane in lanes:
        lane.transfer(bufs[0])
    return dev, bufs, lanes


def main(argv: Optional[List[str]] = None) -> dict:
    """ROUNDS rounds of serial, then each of WAYS; returns the JSON line's
    dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev, bufs, lanes = setup(args.device, N_BUFFERS, seed=7, ways=max(WAYS))
    rounds = []
    for rnd in range(ROUNDS):
        r = {"serial": rates(run_serial(lanes[0], bufs), N_BUFFERS)}
        report(f"serial     x{N_BUFFERS} r{rnd}", r["serial"])
        for ways in WAYS:
            r[f"concurrent{ways}"] = rates(
                run_concurrent(lanes[:ways], bufs), N_BUFFERS)
            report(f"concurrent{ways}x{N_BUFFERS} r{rnd}",
                   r[f"concurrent{ways}"])
        rounds.append(r)
    row = {"tool": "h2d_probe", "device": args.device,
           "buffer_bytes": buffer_bytes(), "buffers": N_BUFFERS,
           "pinned": dev.type == "cuda", "rounds": rounds}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
