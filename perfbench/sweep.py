"""The knee of a serving cell, found once by a sweep of offered rates.

    python3 perfbench/sweep.py --workload <serving cell> --seed 7 \\
        --rates 125,150,175,200,225,250 --seconds 15 [--out sweep.json]

One server is built as the cell's run builds it; then for each rate a
fresh client sends the cell's warm-up and a window at that rate.  For each
rate it prints the offered and completed rates, p50 and p95 from the due
time, failures, and the backlog ratio (the median latency of the window's
last quarter of requests over its first quarter's).  The latency limit is
``LIMIT_X`` times the p95 at the lightest rate; the knee is the highest
rate whose completed rate keeps up (``KEEP_UP``), whose backlog does not
grow (ratio under ``BACKLOG_X``), with no failure and its p95 within the
limit.  The last line gives the knee, the limit and 0.8 of the knee, the
rate the cell file takes.  The benchmark's own runs do not run it.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LIMIT_X = 2.0
KEEP_UP = 0.97
BACKLOG_X = 2.0


def one_rate(cell, server, paths, rate, seconds, seed, tmp) -> dict:
    from perfbench.drivers import serve_open as so
    plan = so.make_plan(cell.traffic, paths, rate, seconds, seed, tmp,
                        tag=f"{rate:g}")
    child = so.start_client(cell, plan)
    try:
        t0 = so.go(child, server.port)
        so._line(child, "done")
        child.wait(timeout=60)
    finally:
        so.stop_client(child)
    recs = so.results(plan)
    lat = so.latencies_ms(recs)
    ok = [r for r in recs if r.get("status") == 200]
    q = max(1, len(recs) // 4)
    first, last = lat[:q], lat[-q:]
    end = max((r["done"] for r in ok), default=t0 + seconds)
    return {"offered_rps": len(recs) / seconds,
            "completed_rps": len(ok) / max(end - t0, seconds),
            "p50_ms": so.percentile(lat, 50), "p95_ms": so.percentile(lat, 95),
            "failed": len(recs) - len(ok),
            "backlog_x": statistics.median(last) / statistics.median(first),
            "outcomes": so.outcomes(recs), "lateness": so.lateness_line(recs)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from perfbench import modelcfg, pool, spec, tokenizer, weights
    from perfbench.drivers import serve_open as so
    cell = spec.load(os.path.join(ROOT, "BENCHMARK.json"), args.workload)
    cfg_json = modelcfg.load(cell.config_file)
    tmp = tempfile.mkdtemp(prefix="perfbench-sweep-")
    rows = []
    try:
        pool_dir = os.path.join(tmp, "pool")
        os.makedirs(pool_dir)
        paths = pool.make_pool(cell.traffic["pool"], args.seed, pool_dir)
        tree = weights.make_weights(modelcfg.dims(cfg_json), args.seed, "cuda")
        server = so.build_server(cfg_json, cell.traffic, tree,
                                 tokenizer.class_names(), "cuda", tmp)
        try:
            for rate in sorted(float(r) for r in args.rates.split(",")):
                row = dict(rate=rate, **one_rate(cell, server, paths, rate,
                                                 args.seconds, args.seed, tmp))
                rows.append(row)
                print(json.dumps(row), flush=True)
                time.sleep(1.0)
        finally:
            server.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    limit = LIMIT_X * rows[0]["p95_ms"]
    good = [r["rate"] for r in rows
            if r["completed_rps"] >= KEEP_UP * r["offered_rps"]
            and r["backlog_x"] < BACKLOG_X and r["failed"] == 0
            and r["p95_ms"] <= limit]
    knee = max(good) if good else None
    summary = {"latency_limit_ms": limit, "knee_rps": knee,
               "rate_rps": 0.8 * knee if knee else None, "rows": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
