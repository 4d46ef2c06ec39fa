"""Aggregate metric JSONs across scene/envmap runs into mean ± std
(≙ collect_results.py, of which this is a copy; numpy only).

    python -m irgs_tpu_torch.tools.collect_results <model_dir>... \
        [--kind nvs|material|relight]

Walks the model dirs, reads test/nvs_results.json, material_results.json
or relighting_results.json (as the port's eval CLIs write them), prints a
row per scene and the aggregate.
"""

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m irgs_tpu_torch.tools.collect_results")
    parser.add_argument("model_paths", nargs="+")
    parser.add_argument("--kind", choices=["nvs", "material", "relight"],
                        default="nvs")
    args = parser.parse_args(argv)

    fname = {"nvs": os.path.join("test", "nvs_results.json"),
             "material": "material_results.json",
             "relight": "relighting_results.json"}[args.kind]

    rows = {}
    for mp in args.model_paths:
        path = os.path.join(mp, fname)
        if not os.path.exists(path):
            print(f"[skip] {path} missing", file=sys.stderr)
            continue
        with open(path) as f:
            r = json.load(f)
        if args.kind == "relight":
            r = r.get("average", r)
        rows[os.path.basename(mp.rstrip("/"))] = r

    if not rows:
        print("no results found")
        return
    keys = [k for k, v in next(iter(rows.values())).items()
            if isinstance(v, (int, float)) and v is not None]
    for name, r in sorted(rows.items()):
        print(name, " ".join(f"{k}={r.get(k):.4f}" for k in keys
                             if isinstance(r.get(k), (int, float))))
    print("----")
    for k in keys:
        vals = [r[k] for r in rows.values()
                if isinstance(r.get(k), (int, float))]
        if vals:
            print(f"{k}: {np.mean(vals):.4f} ± {np.std(vals):.4f}  (n={len(vals)})")


if __name__ == "__main__":
    main()
