"""The readings that a cell's limits are set from, other than the program's.

    python3 -m portbench.calibrate --workload <cell> --seeds <n> [<n> ...]

For each seed, at the cell's own sizes, on the card:

- serve cells: the control, the reference computed with float8 e4m3
  operands, answering the first ``check_requests`` requests of each client's
  pool, against the float32 reference on the same requests
  (``compare.answer_gaps``);
- train cells: the control's three steps against the float32 reference's
  (``loss_gap``, ``grad_gap``, ``update_gap``), and the fault "half of the
  batch left out": the reference on the first half of each batch's rows
  against the reference on all of them.  The fault "a step that returns its
  state unchanged" reads 1 on ``update_gap`` by construction and needs no run.

With ``--program``, a train cell also gives the program's own readings on
each seed: the steps that a run's set-up drives through ``Trainer.train_step``
against the reference's, without the measured window, so that a dozen seeds
share one process's set-up.  A serve cell's program readings need the
window's load and come from the runs themselves.

One JSON line per seed and reading.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import compare, run, weights


def serve_control(setup: dict, seed: int, device) -> dict:
    cfg, mix, fam = setup["config"], setup["mix"], setup["family"]
    params = weights.make_params(fam.shapes(cfg), seed % run.SEED_MOD, device)
    pools = run.serve_pools(fam, cfg, mix, seed, device)
    picked = [arrays for pool in pools for arrays in pool[:mix["check_requests"]]]
    got = [run.reference_answers(fam, cfg, params, a, device, "fp8") for a in picked]
    return compare.answer_gaps(got, *run.reference_pair(fam, cfg, params, picked, device))


def train_readings(setup: dict, seed: int, device) -> dict:
    exact = run.reference_steps(setup, seed, device, "exact")
    control = run.reference_steps(setup, seed, device, "fp8")
    half = run.reference_steps(setup, seed, device, "exact", rows=setup["mix"]["batch"] // 2)
    return {"control": compare.train_gaps(control, exact),
            "half_batch": compare.train_gaps(half, exact)}


def program_readings(setup: dict, seed: int, device) -> dict:
    program = run.program_steps(setup, seed, device)[2]
    torch.cuda.empty_cache()
    return compare.train_gaps(program, run.reference_steps(setup, seed, device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="a train cell's program readings instead of the control's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA card", file=sys.stderr)
        return 2
    setup = run.resolve(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        if setup["mix"]["kind"] == "serve":
            readings = {"control": serve_control(setup, seed, device)}
        elif args.program:
            readings = {"program": program_readings(setup, seed, device)}
        else:
            readings = train_readings(setup, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **readings}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
