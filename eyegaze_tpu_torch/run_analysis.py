"""Batch analysis runner: analyses every gaze model kind and fusion mode.

    python -m eyegaze_tpu_torch.run_analysis [--tiny] [--trials 12] \\
        [--only early:concat late:full ...] [--device cpu]

The counterpart of the JAX package's root ``run_analysis.py`` (the
reference's ``run_analysis.py:22-101``): the same specs and flags, plus
``--device``, which it passes on.  It runs ``python -m
eyegaze_tpu_torch.analyze_gaze`` once per (model kind, fusion mode), goes
on after a failure, reports pass or fail per run and exits 1 if any
failed.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

EARLY_MODES = ("concat", "add", "subtract", "subtract_abs", "multiply")
LATE_MODES = ("concat", "add", "subtract", "multiply", "full")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--output-dir", default="runs/analysis_all")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--only", nargs="*", default=None,
                    help="subset of kind:mode specs")
    ap.add_argument("--device", default="cuda",
                    help="torch device for each analysis (default the CUDA card; 'cpu' must be "
                         "asked for)")
    args = ap.parse_args(argv)

    specs = [f"early:{m}" for m in EARLY_MODES] + [f"late:{m}" for m in LATE_MODES]
    if args.only:
        specs = [s for s in specs if s in args.only]

    results = {}
    for spec in specs:
        kind, mode = spec.split(":")
        cmd = [sys.executable, "-m", "eyegaze_tpu_torch.analyze_gaze",
               "--model", kind, "--fusion-mode", mode,
               "--output-dir", str(Path(args.output_dir) / f"{kind}_{mode}"),
               "--trials", str(args.trials), "--device", args.device]
        if args.tiny:
            cmd.append("--tiny")
        print(f"[run_analysis] {spec}", flush=True)
        rc = subprocess.run(cmd).returncode
        results[spec] = rc == 0
        if rc != 0:
            print(f"[run_analysis] {spec} FAILED; continuing")

    print("\n=== Summary ===")
    for spec, ok in results.items():
        print(f"  {'PASS' if ok else 'FAIL'}  {spec}")
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
