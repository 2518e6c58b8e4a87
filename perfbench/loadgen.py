"""The open-loop client of the serving cells, a child process of the run.

    python3 perfbench/loadgen.py <plan.json>

It reads the pool's JPEG bytes into memory, then waits for ``go <port>`` on
standard input.  It sends the plan's warm-up requests, then announces the
window (``window <epoch seconds>`` on standard output) and sends the
window's requests, each at its due time whether or not earlier ones have
finished: one ``POST /v1/score`` of one JPEG a connection.  Each request
is timed from its due time to the last byte of its response; one that has
no response by the plan's deadline has none.  The results go to the
plan's ``out`` file, then ``done`` on standard output.  Standard library
only, one thread: an asyncio loop.
"""

import asyncio
import json
import sys
import time


async def _post(port: int, body: bytes):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(b"POST /v1/score HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                     b"Content-Type: image/jpeg\r\nConnection: close\r\n"
                     b"Content-Length: " + str(len(body)).encode()
                     + b"\r\n\r\n" + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
    head, _, payload = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    score = None
    if status == 200:
        score = json.loads(payload)["scores"][0]
    return status, score


async def _one(port, body, due, deadline, rec):
    now = time.time()
    if due > now:
        await asyncio.sleep(due - now)
    rec["start"] = time.time()
    try:
        rec["status"], rec["score"] = await asyncio.wait_for(
            _post(port, body), max(0.0, deadline - time.time()))
        rec["done"] = time.time()
    except asyncio.TimeoutError:
        rec["error"] = "no response by the deadline"
    except (OSError, ValueError, IndexError, KeyError) as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["done"] = time.time()


async def _phase(port, bodies, requests, t0, deadline):
    recs = [{"image": img, "due": t0 + off} for off, img in requests]
    tasks = [asyncio.ensure_future(_one(port, bodies[r["image"]], r["due"],
                                        deadline, r)) for r in recs]
    await asyncio.gather(*tasks)
    return recs


async def _main(plan, bodies, port):
    t0 = time.time() + 0.2
    await _phase(port, bodies, plan["warmup"], t0,
                 t0 + plan["warmup_s"] + plan["grace_s"])
    t0 = time.time() + 0.3
    print(f"window {t0!r}", flush=True)
    recs = await _phase(port, bodies, plan["window"], t0,
                        t0 + plan["seconds"] + plan["grace_s"])
    with open(plan["out"], "w") as f:
        json.dump({"t0": t0, "requests": recs}, f)
    print("done", flush=True)


def main() -> int:
    with open(sys.argv[1]) as f:
        plan = json.load(f)
    bodies = []
    for p in plan["paths"]:
        with open(p, "rb") as f:
            bodies.append(f.read())
    line = sys.stdin.readline().split()
    if len(line) != 2 or line[0] != "go":
        return 1
    asyncio.run(_main(plan, bodies, int(line[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
