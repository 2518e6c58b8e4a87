"""The control of a cell's output check: the reference put in the
program's place, one precision step below the configuration's bfloat16
(every dense product in float8 e4m3), scored by the cell's own comparison
against the reference that the configuration names.
It has to come out not correct.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's pool, weights and token ids as a run
does, scores every file of the pool with the float32 reference and with
the control, and prints one JSON line: the control's ``score_gap`` beside
the cell's limit.  The benchmark's own runs do not run it.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_gap(cell, seed: int, device: str, gemm: str = "fp8") -> float:
    from perfbench import compare, modelcfg, pool, tokenizer, weights

    cfg_json = modelcfg.load(cell.config_file)
    dims = modelcfg.dims(cfg_json)
    ref = modelcfg.reference(cell.root, cfg_json)
    with tempfile.TemporaryDirectory(prefix="perfbench-control-") as tmp:
        paths = pool.make_pool(cell.traffic["pool"], seed, tmp)
        tree = weights.make_weights(dims, seed, device)
        ids, mask = tokenizer.tokenize(
            tokenizer.prompts(tokenizer.class_names()),
            dims["text"]["vocab_size"], dims["text"]["context_length"])
        T = cell.traffic["T"]
        want = ref.score_of_paths(tree, dims, paths, ids, mask, T, device)
        got = ref.score_of_paths(tree, dims, paths, ids, mask, T, device,
                                 gemm=gemm)
    return compare.worst_relative_gap(got, want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from perfbench import spec
    cell = spec.load(os.path.join(ROOT, "BENCHMARK.json"), args.workload)
    limit = cell.params["limits"]["score_gap"]
    gaps = {int(s): control_gap(cell, int(s), args.device)
            for s in args.seeds.split(",")}
    print(json.dumps({"workload": args.workload, "control": "fp8 gemms",
                      "score_gap": gaps, "limit": limit,
                      "all_fail": all(g > limit for g in gaps.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
