"""Render the reference's MATLAB figure suites natively (no MATLAB needed).

The reference's analysis story ends with three MATLAB scripts
(``7_Analysis/matlab_scripts/analyze_{ibs_connectivity,attention_weights,
gradcam}.m``) run by hand over the CSV tree the Python pipeline writes.
This CLI is that step, natively: point it at an ``analyze_eeg`` output
directory (or, for the entropy suite, an ``analyze_entropy`` one) and it
renders the same figures with the same filenames.

    python -m eyegaze_tpu_torch.render_matlab_figures --result-dir runs/analysis \
        [--output-dir runs/analysis/figures] [--suites ibs,attention,gradcam]
        [--band theta] [--feature PLV]

The counterpart of the JAX package's ``scripts/render_matlab_figures.py``:
the same flags and files, rendered by the port's ``analysis/matlab_parity``
on the host (pandas and matplotlib; no device work).  The original ``.m``
scripts still run unchanged over the same tree (``utils/io_csv.py`` keeps
the byte contract); this renderer removes the MATLAB dependency, it does
not replace the contract.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from eyegaze_tpu_torch.analysis.eeg_introspect import CHANNEL_POSITIONS_2D
from eyegaze_tpu_torch.analysis.matlab_parity import (
    render_attention_suite,
    render_entropy_suite,
    render_gradcam_suite,
    render_ibs_suite,
)

SUITES = ("ibs", "attention", "gradcam", "entropy")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--result-dir", required=True,
                    help="analyze_eeg output directory (the CSV tree)")
    ap.add_argument("--output-dir", default=None,
                    help="figure root (default: <result-dir>/figures)")
    ap.add_argument("--suites", default="ibs,attention,gradcam",
                    help=f"comma list from {SUITES}")
    ap.add_argument("--band", default="theta",
                    help="key band for the IBS suite")
    ap.add_argument("--feature", default="PLV",
                    help="key feature for the IBS suite")
    args = ap.parse_args(argv)

    result_dir = Path(args.result_dir)
    out_root = Path(args.output_dir or result_dir / "figures")
    wanted = [s.strip() for s in args.suites.split(",") if s.strip()]
    bad = set(wanted) - set(SUITES)
    if bad:
        ap.error(f"unknown suites {sorted(bad)}; choose from {SUITES}")

    n_total = 0
    for suite in wanted:
        try:
            if suite == "ibs":
                produced = render_ibs_suite(
                    result_dir, out_root / "ibs_connectivity_native",
                    key_band=args.band, key_feature=args.feature)
            elif suite == "attention":
                produced = render_attention_suite(
                    result_dir, out_root / "attention_weights_native")
            elif suite == "entropy":
                # analyze_entropy writes its CSVs at the dir root; the 2D
                # montage comes from the introspection layer.
                produced = render_entropy_suite(
                    result_dir, out_root / "entropy_native",
                    positions=CHANNEL_POSITIONS_2D)
            else:
                produced = render_gradcam_suite(
                    result_dir, out_root / "gradcam_native")
        except FileNotFoundError as e:
            print(f"[figures] {suite}: skipped ({e})")
            continue
        for name, path in produced.items():
            print(f"[figures] {suite}: {path}")
        n_total += len(produced)
    print(f"[figures] done — {n_total} artifacts under {out_root}")
    return 0 if n_total else 1


if __name__ == "__main__":
    sys.exit(main())
