"""Write complete_metadata.json from raw description records.

The counterpart of ``scripts/generate_metadata.py``:

    python -m eyegaze_tpu_torch.generate_metadata --inputs desc1.json desc2.json \
        --output complete_metadata.json

Joins the description JSONs (each a record or a list of them), keeps pairs
12-40 without pair 18, takes each record's class from the record or from
player1's file name, writes the records every dataset reads and checks
them (``data/metadata.py``); exit code 1 if the check finds a problem.
"""

from __future__ import annotations

import argparse
import json

from eyegaze_tpu_torch.data.metadata import generate_metadata, verify_metadata


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--inputs", nargs="+", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)

    records = []
    for path in args.inputs:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        records.extend(data if isinstance(data, list) else [data])

    metadata = generate_metadata(records)
    report = verify_metadata(metadata)
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(metadata, f, ensure_ascii=False, indent=2)
    print(f"[generate_metadata] wrote {report['num_records']} records -> {args.output}")
    print(f"  class counts: {report['class_counts']}")
    print(f"  pairs: {report['pairs'][:5]}...{report['pairs'][-3:]}")
    if not report["ok"]:
        print(f"  PROBLEMS: {report['problems']}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
