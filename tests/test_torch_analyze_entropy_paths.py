"""``python -m eyegaze_tpu_torch.analyze_entropy`` against the JAX script on
its two computing paths: here ``--gaze-dir`` / ``--eeg-dir`` over
tests/test_scripts.py's tree (four reference-named trials, JPGs of (40, 64,
3) and CSVs of (32, 512), and the files both must skip: a broken JPG, an
8-channel CSV, a free-text CSV); the default synthetic path (``--trials
12``) in tests/test_torch_analyze_entropy_synthetic.py.

The two output trees are equal.  In every table the discrete columns (keys,
conditions, counts) are equal; the entropies, their means and standard
deviations are held at ``ENTROPY_TOL``; the t statistics and p-values at
``STAT_RTOL`` of their size.

``ENTROPY_TOL``: the spectral entropy is a float32 filtfilt, Welch and
entropy on both sides, by different recurrences.  Against scipy's filtfilt
and Welch in float64, on normal (4, 32, T) trials, each framework's
entropies stand within 3e-4 at T = 512 (the files' length: the 0.5 Hz
pole's edge transient fills much of a short trial), 1.5e-4 at T = 1024
(the synthetic path's) and 5e-5 at T = 3250
(tests/test_torch_analyze_entropy_synthetic.py holds them); so the two
stand within the sum of their gaps, 6e-4.  The spatial entropies agree to a
relative 1e-5 (tests/test_torch_entropy.py).
"""

import csv
import io

import numpy as np

from eyegaze_tpu_torch import analyze_entropy
from tests.test_torch_analyze_entropy import _script, tree

ENTROPY_TOL = 6e-4
STAT_RTOL = 1e-3
DISCRETE = {"pair_id", "player", "trial_idx", "condition", "Condition", "N", "count", "A", "B"}
TABLES = ("gaze_entropy_raw.csv", "eeg_entropy_raw.csv", "gaze_entropy_by_pair.csv",
          "eeg_entropy_by_pair.csv", "gaze_entropy_summary.csv", "eeg_entropy_summary.csv",
          "gaze_entropy_tests.csv", "eeg_entropy_tests.csv")
NAMES = ("Pair-12-A-Single-EYE_trial1_player", "Pair-12-B-Single-EYE_trial1_observer",
         "Pair-13-Comp-EYE_trial2_playerA", "Pair-13-Coop-EYE_trial3_playerB")


def file_tree(root):
    """tests/test_scripts.py::test_analyze_entropy_real_files's directories."""
    from PIL import Image

    gaze_dir, eeg_dir = root / "gaze", root / "eeg"
    gaze_dir.mkdir()
    eeg_dir.mkdir()
    r = np.random.default_rng(0)
    for name in NAMES:
        img = r.integers(0, 255, size=(40, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(gaze_dir / f"{name}.jpg", quality=95)
        eeg = r.normal(size=(32, 512)).astype(np.float32)
        np.savetxt(eeg_dir / f"{name}.csv", eeg, delimiter=",", fmt="%.5f")
    (gaze_dir / "notes.jpg").write_bytes(b"not an image")
    np.savetxt(eeg_dir / "Pair-14-Comp-EYE_trial1_playerA.csv",
               r.normal(size=(8, 64)), delimiter=",", fmt="%.4f")
    (eeg_dir / "README.csv").write_text("freeform,text\n")
    return gaze_dir, eeg_dir


def assert_tables_match(got_dir, want_dir) -> dict:
    """Holds every table as the module docstring says; returns the largest
    gap of each kind."""
    gaps = {"entropy": 0.0, "stat": 0.0}
    for name in TABLES:
        got, want = (list(csv.reader(io.StringIO((d / name).read_text())))
                     for d in (got_dir, want_dir))
        assert got[0] == want[0] and len(got) == len(want), name
        for g, w in zip(got[1:], want[1:]):
            for col, a, b in zip(got[0], g, w):
                if col in DISCRETE or not a or not b:  # an empty cell: NaN on both
                    assert a == b, (name, col)
                elif col in ("t", "p"):
                    gap = abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)
                    gaps["stat"] = max(gaps["stat"], gap)
                    assert gap <= STAT_RTOL, (name, col, a, b)
                else:
                    gap = abs(float(a) - float(b))
                    gaps["entropy"] = max(gaps["entropy"], gap)
                    assert gap <= ENTROPY_TOL, (name, col, a, b)
    return gaps


def run_both(tmp_path, flags: list) -> dict:
    """Both CLIs with ``flags``; holds their trees and tables.  Returns the
    largest gaps."""
    want, got = tmp_path / "jax", tmp_path / "port"
    assert _script("analyze_entropy").main(flags + ["--output-dir", str(want)]) == 0
    assert analyze_entropy.main(flags + ["--output-dir", str(got), "--device", "cpu"]) == 0
    assert tree(got) == tree(want)
    assert set(TABLES) <= set(tree(got))
    return assert_tables_match(got, want)


def test_file_path_matches(tmp_path):
    gaze_dir, eeg_dir = file_tree(tmp_path)
    gaps = run_both(tmp_path, ["--gaze-dir", str(gaze_dir), "--eeg-dir", str(eeg_dir),
                               "--fs", "256"])
    rows = list(csv.DictReader(io.StringIO((tmp_path / "port" / "eeg_entropy_raw.csv")
                                           .read_text())))
    assert [(r["pair_id"], r["player"], r["condition"]) for r in rows] == [
        ("12", "A_player", "Single"), ("12", "B_observer", "Single"),
        ("13", "playerA", "Competition"), ("13", "playerB", "Cooperation")]
    print(f"largest gaps {gaps}")
