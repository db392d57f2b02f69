"""The benchmark of cloudberry_tpu_torch on NVIDIA GPUs.

    python3 cbbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card(s) of this machine and
prints one JSON object as its last line of standard output. It exits
with another code than 0, and prints no result, without CUDA, with fewer
cards than the cell asks for, or when the program is not beside it.
"""

import os
import sys
import time

T_START = time.perf_counter()
# modules that may not be loaded in the process that prints the result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "cloudberry_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "cbbench", ".cache")
# every build and kernel cache lives at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cbbench import bench

    spec = bench.load_spec()
    cell = next((w for w in spec["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['chips']} cards wanted, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    out = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START)
    # after the check and the metric readers, just before the result line
    leftover = [m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN]
    if leftover:
        print(f"modules that may not load were loaded: {sorted(leftover)}",
              file=sys.stderr)
        return 4
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
