"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: it builds the program's kernels into the
checkout's ``build/`` and puts every other file of the run in a fresh
directory under ``TMPDIR``.  It exits non-zero, printing no result, without
a CUDA card (or fewer than the cell asks for), without the program beside
it, or when ``jax``, ``jaxlib``, ``flax`` or the JAX package was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from perfbench import harness, spec
    cell = spec.load(os.path.join(ROOT, "BENCHMARK.json"), args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import mcm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is not beside the benchmark ({e})",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T_START)
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
