"""The port's CSV writers (``eyegaze_tpu_torch/utils/io_csv.py``, no pandas)
against the JAX package's (pandas): every writer, on the same numpy inputs,
byte for byte, with float32, float64, int and bool columns."""

import numpy as np
import pytest

from eyegaze_tpu.utils import io_csv as jax_io
from eyegaze_tpu_torch.utils import io_csv

CLASSES = ["Single", "Competition", "Cooperation"]


def _inputs():
    r = np.random.default_rng(3)
    y_true = r.integers(0, 3, 17)
    y_pred = np.where(r.random(17) < 0.6, y_true, r.integers(0, 3, 17))
    probs = r.dirichlet(np.ones(3), 17).astype(np.float32)
    return r, y_true, y_pred, probs


def _write_both(tmp_path, name, write):
    """``write(module, path)`` with each package's io_csv; the two files' bytes."""
    want, got = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    write(jax_io, want)
    write(io_csv, got)
    return want.read_bytes(), got.read_bytes()


def _embedding(module, path, r):
    cols = {"Sample_ID": np.arange(5), "True_Label": ["Single", "Comp,etition", "x", "y", "z"],
            "Pred_Label": ["a", "b", "c", "d", "e"],
            "Dim_1": r.normal(size=5).astype(np.float32), "Dim_2": r.normal(size=5),
            "Flag": np.array([True, False, True, True, False]),
            "Small": np.array([1e-5, 1e16, np.nan, -np.inf, 0.1], np.float32)}
    if module is jax_io:
        import pandas as pd

        cols = pd.DataFrame(cols)
    module.save_embedding_results(cols, path)


def _cases():
    r, y_true, y_pred, probs = _inputs()
    cm = np.bincount(y_true * 3 + y_pred, minlength=9).reshape(3, 3)
    metrics = {"accuracy": float(np.float32(0.7058824)), "f1_macro": 1 / 3, "tiny": 1e-5,
               "big": 12345678.9, "int_like": 2.0}
    sens = {b: {"accuracy": float(np.float32(a)), "f1": float(np.float32(f))}
            for b, a, f in zip(["delta", "theta", "alpha"], r.random(3), r.random(3))}
    long_rows = [{"Subject_ID": i, "True_Label": CLASSES[i % 3], "Pred_Label": "Single",
                  "Band": "alpha", "Feature": "PLV", "Channel_1": "Fp1", "Channel_2": i,
                  "Value": float(r.normal())} for i in range(4)]
    summary = [{"Class": c, "Mean_Diagonal": float(r.random()), "Std_Diagonal": 0.0,
                "Mean_OffDiag": float(np.float32(r.random())), "Std_OffDiag": 1e-7}
               for c in CLASSES]
    mixed = [{"A": np.float32(0.1), "B": True, "C": 3, "D": None},
             {"A": np.float32(1 / 3), "B": False, "C": np.int32(4), "D": 2.5},
             {"A": np.float32(2.0), "B": True, "C": 5, "E": "x"}]
    mat = r.normal(size=(6, 6)).astype(np.float32)
    return {
        "confusion_matrix": lambda m, p: m.save_confusion_matrix(cm, p, CLASSES),
        "confusion_matrix_float": lambda m, p: m.save_confusion_matrix(
            cm.astype(np.float32) / 7, p, CLASSES),
        "classification_report": lambda m, p: m.save_classification_report(
            y_true, y_pred, p, CLASSES),
        "overall_metrics": lambda m, p: m.save_overall_metrics(metrics, p),
        "frequency_sensitivity": lambda m, p: m.save_frequency_sensitivity(
            sens, p, 0.75, float(np.float32(0.6))),
        "ibs_long_format": lambda m, p: m.save_ibs_long_format(long_rows, p),
        "ibs_long_format_mixed": lambda m, p: m.save_ibs_long_format(mixed, p),
        "ibs_matrix": lambda m, p: m.save_ibs_matrix(mat, p),
        "channel_names": lambda m, p: m.save_channel_names(["Fp1", "Fz", "F3"], p),
        "attention_summary": lambda m, p: m.save_attention_summary(summary, p),
        "attention_matrix": lambda m, p: m.save_attention_matrix(mat.astype(np.float64), p),
        "embedding_results": lambda m, p: _embedding(m, p, np.random.default_rng(4)),
        "gradcam_results": lambda m, p: m.save_gradcam_results(mat[:4], p),
        "gradcam_metadata": lambda m, p: m.save_gradcam_metadata(
            np.linspace(0, 128.0, 64), np.linspace(0, 4.0, 64), p, 256),
        "predictions": lambda m, p: m.save_predictions(y_true, y_pred, probs, p, CLASSES),
        "predictions_ids_no_probs": lambda m, p: m.save_predictions(
            y_true.astype(np.int32), y_pred, None, p, CLASSES,
            sample_ids=[f"s{i}" for i in range(17)]),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_writer_bytes_match_jax(tmp_path, name):
    want, got = _write_both(tmp_path, name, _cases()[name])
    assert got == want, f"\nJAX:\n{want.decode()[:600]}\nport:\n{got.decode()[:600]}"


def test_output_dirs_match_jax(tmp_path):
    want = jax_io.ensure_output_dirs(tmp_path / "jax")
    got = io_csv.ensure_output_dirs(tmp_path / "port")
    assert list(got) == list(want)
    for k in want:
        assert got[k].relative_to(tmp_path / "port") == want[k].relative_to(tmp_path / "jax")
        assert got[k].is_dir()


def test_classification_report_columns(tmp_path):
    """The port returns the columns it wrote (JAX returns the DataFrame)."""
    _, y_true, y_pred, _ = _inputs()
    cols = io_csv.save_classification_report(y_true, y_pred, tmp_path / "r.csv", CLASSES)
    df = jax_io.save_classification_report(y_true, y_pred, tmp_path / "j.csv", CLASSES)
    assert list(cols) == list(df.columns)
    for k in cols:
        np.testing.assert_array_equal(np.asarray(cols[k]), df[k].to_numpy())
