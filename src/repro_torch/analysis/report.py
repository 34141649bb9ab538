"""Roofline report CLI: renders the roofline table from the dry run's
JSON (``launch/dryrun.py``, ``build/dryrun/``); the times are analytic
H100 predictions from data-sheet peaks, not measurements.

    PYTHONPATH=src python -m repro_torch.analysis.report [--markdown]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")


def load_rows():
    rows = []
    for p in sorted(glob.glob(os.path.join(RESULTS, "*__pod1.json"))):
        r = json.load(open(p))
        if "roofline" not in r:
            continue
        ro = r["roofline"]
        m = r["memory"]
        rows.append((r["arch"], r["shape"], ro["dominant"],
                     ro["t_compute_s"] * 1e3, ro["t_memory_s"] * 1e3,
                     ro["t_collective_s"] * 1e3, ro["useful_flops_ratio"],
                     (m["argument_bytes"] + m["temp_bytes"]) / 1e9,
                     r["meta"].get("layout", "?"), r["meta"].get("tp", 0)))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    rows = load_rows()
    if not rows:
        raise SystemExit("no dry-run artifacts; run "
                         "repro_torch.launch.dryrun")
    if args.markdown:
        print("| arch × shape | layout | tp | dominant | compute ms |"
              " memory ms | collective ms | useful | GB/dev |")
        print("|---|---|---:|---|---:|---:|---:|---:|---:|")
        for a, s, d, c, mm, co, u, gb, lay, tp in rows:
            print(f"| {a} × {s} | {lay} | {tp} | {d} | {c:.2f} | {mm:.1f} "
                  f"| {co:.2f} | {u:.3f} | {gb:.1f} |")
        return
    print(f"{'arch':22s} {'shape':12s} {'lay':7s} {'tp':>4s} {'dom':10s} "
          f"{'comp_ms':>9s} {'mem_ms':>9s} {'coll_ms':>9s} {'useful':>7s} "
          f"{'GB/dev':>7s}")
    for a, s, d, c, mm, co, u, gb, lay, tp in rows:
        print(f"{a:22s} {s:12s} {lay:7s} {tp:4d} {d:10s} {c:9.2f} "
              f"{mm:9.1f} {co:9.2f} {u:7.3f} {gb:7.1f}")
    doms = {}
    for _, _, d, *_ in rows:
        doms[d] = doms.get(d, 0) + 1
    print(f"\n{len(rows)} pairs; dominant terms: {doms}")


if __name__ == "__main__":
    main()
