"""The control of ``correct``: the plain reference put in the program's
place, computed in a lower precision than the configuration states, must
come out not correct.

    python3 cbbench/control.py --workload <cell> --seeds 1,2,3 [--mode float64]

For each seed it makes the cell's data as a run does, takes the distinct
statements that a run's clients send first (as many as a run checks),
computes each with the reference at the lower precision (``float64``:
DECIMAL arithmetic in float64 instead of int64 fixed-point, the step that
would tempt a later change; ``float32``: DECIMAL and the floats derived
from it in float32) and compares it, as the clients' answer, with the
exact reference. It prints each seed's compared numbers and whether they
pass their limits. The benchmark's own runs never run it.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def statements(tr, n_per_client: int) -> list:
    """The distinct statements of the clients' first ``n_per_client``
    statements each, in the order the check draws them."""
    keys = []
    for i in range(int(tr.mix["clients"])):
        it = tr.client(i)
        keys += [next(it).key for _ in range(n_per_client)]
    return tr.check_sample(keys)


def control_gaps(cell: str, seed: int, mode: str, device, scale=None,
                 n_per_client: int = 16):
    import importlib
    import json

    import torch

    from cbbench import bench, check, traffic
    from cbbench.check import Gaps
    from cbbench.reference.common import DB

    spec = bench.load_spec()
    w = next(x for x in spec["workloads"] if x["name"] == cell)
    c = next(x for x in spec["configs"] if x["name"] == w["config"])
    config = json.loads((bench.ROOT / c["file"]).read_text())
    mix = traffic.load_mix(w["traffic"])
    templates = traffic.load_templates(mix["family"], mix["templates"])
    tables = sorted({t for tpl in templates.values() for t in tpl["tables"]})
    gen = importlib.import_module(f"cbbench.gen.{mix['family']}")
    made = gen.make(config["scale"] if scale is None else scale, seed,
                    device, tables)
    host = {t: m.to_host() for t, m in made.items()}
    del made
    tr = traffic.Traffic(mix, templates, seed)
    exact = DB(host, device, exact=True)
    low = DB(host, device, exact=False,
             float_dtype=torch.float32 if mode == "float32"
             else torch.float64)
    gaps = Gaps()
    for key in statements(tr, n_per_client):
        mod = importlib.import_module(
            f"cbbench.reference.{mix['family']}.{key[0]}")
        params = dict(key[1])
        ref = mod.answer(exact, params)
        got = mod.answer(low, params)
        rows = got.rows if got.limit is None else got.rows[:got.limit]
        gaps.add(check.compare(ref, rows))
    return gaps


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", choices=("float64", "float32"),
                    default="float64")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from cbbench import check

    for seed in (int(s) for s in args.seeds.split(",")):
        gaps = control_gaps(args.workload, seed, args.mode, "cuda")
        line = {"workload": args.workload, "seed": seed, "mode": args.mode,
                "checked": gaps.checked, "correct": gaps.correct(),
                "compared": {k: {"value": v, "limit": check.LIMITS[k]}
                             for k, v in gaps.numbers().items()}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
