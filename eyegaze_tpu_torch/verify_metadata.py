"""Check a complete_metadata.json file.

The counterpart of ``scripts/verify_metadata.py``:

    python -m eyegaze_tpu_torch.verify_metadata complete_metadata.json

Pair 18 excluded, pairs within 12-40, the class counts, no empty required
field (``data/metadata.py::verify_metadata``); exit code 1 on a problem.
"""

from __future__ import annotations

import argparse

from eyegaze_tpu_torch.data.metadata import load_metadata, verify_metadata


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("metadata", help="path to complete_metadata.json")
    args = ap.parse_args(argv)

    report = verify_metadata(load_metadata(args.metadata))
    print(f"records: {report['num_records']}")
    print(f"pairs:   {report['pairs']}")
    print(f"classes: {report['class_counts']}")
    if report["ok"]:
        print("OK: all checks passed")
        return 0
    print(f"FAILED: {report['problems']}")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
