"""CSV export layer: the data contract with the MATLAB figure suite.

The port's copy of ``eyegaze_tpu/utils/io_csv.py`` (the reference's
``6_Utils/io_utils.py:18-372``): the same directory tree, file names,
columns and bytes (``docs/PARITY.md``, "CSV contract"), without pandas.
Tables are written with the ``csv`` module as ``DataFrame.to_csv`` writes
them: a column given as a numpy array keeps its dtype, a column given as a
list takes the dtype pandas would infer (``_column``); float32 cells are
``str(np.float32(x))``, float64 cells the shortest repr, ints as ints,
bools as ``True`` / ``False``, NaN as an empty cell, quoting minimal, lines
ending in ``\\n``.  The matrices are headerless ``%.6f`` for MATLAB's
``readmatrix()``.
"""

from __future__ import annotations

import csv
import math
import numbers
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from eyegaze_tpu_torch.train.metrics import confusion_matrix, per_class_metrics

PathLike = Union[str, Path]


def ensure_output_dirs(base_path: PathLike) -> Dict[str, Path]:
    base = Path(base_path)
    subdirs = {
        "core_metrics": base / "core_metrics",
        "frequency_sensitivity": base / "frequency_sensitivity",
        "ibs_connectivity": base / "ibs_connectivity",
        "ibs_mean_by_class": base / "ibs_connectivity" / "ibs_mean_by_class",
        "ibs_difference": base / "ibs_connectivity" / "ibs_difference_coop_vs_comp",
        "attention_weights": base / "attention_weights",
        "attention_mean_by_class": base / "attention_weights" / "attention_mean_by_class",
        "feature_embeddings": base / "feature_embeddings",
        "gradcam": base / "gradcam",
        "gradcam_mean_by_class": base / "gradcam" / "gradcam_mean_by_class",
    }
    for p in subdirs.values():
        p.mkdir(parents=True, exist_ok=True)
    return subdirs


def _missing(x) -> bool:
    return x is None or (isinstance(x, (float, np.floating)) and math.isnan(x))


def _format_array(a: np.ndarray) -> List[str]:
    """Cells of a numpy column as pandas writes them: ``astype(str)``, NaN
    as an empty cell."""
    cells = a.astype(str).tolist()
    if a.dtype.kind == "f":
        cells = ["" if math.isnan(x) else c for x, c in zip(a.tolist(), cells)]
    return cells


def _column(values) -> List[str]:
    """The cells of one column.  A numpy array keeps its dtype; a list takes
    the dtype pandas infers for it: all bool -> bool, all int -> int64,
    numbers (missing cells included) -> float32 if every one is a float32
    scalar, else float64; anything else is an object column, each cell
    ``str(x)``."""
    if isinstance(values, np.ndarray):
        return _format_array(values)
    values = list(values)
    present = [v for v in values if not _missing(v)]
    is_bool = [isinstance(v, (bool, np.bool_)) for v in present]
    is_num = [isinstance(v, numbers.Number) and not b for v, b in zip(present, is_bool)]
    if present and all(is_bool) and len(present) == len(values):
        return [str(bool(v)) for v in values]
    if present and all(is_num):
        ints = all(isinstance(v, numbers.Integral) for v in present)
        if ints and len(present) == len(values):
            return [str(int(v)) for v in values]
        dtype = np.float32 if all(isinstance(v, np.float32) for v in present) else np.float64
        return _format_array(np.asarray([np.nan if _missing(v) else v for v in values], dtype))
    return ["" if _missing(v) else str(v) for v in values]


def _write_columns(columns: Mapping[str, object], path: PathLike,
                   index: Optional[Sequence[str]] = None) -> None:
    """``DataFrame(columns).to_csv(path, index=index is not None)``, the
    index column's header empty."""
    names = list(columns)
    cells = [_column(columns[k]) for k in names]
    n = len(cells[0]) if cells else 0
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(([""] if index is not None else []) + names)
        for i in range(n):
            w.writerow(([str(index[i])] if index is not None else []) + [c[i] for c in cells])


def _write_records(records: Sequence[Mapping], path: PathLike) -> None:
    """``DataFrame(records).to_csv(path, index=False)``: the columns in the
    order their keys first appear, a key a record lacks a missing cell."""
    names: List[str] = []
    for r in records:
        names += [k for k in r if k not in names]
    _write_columns({k: [r.get(k) for r in records] for k in names}, path)


def save_confusion_matrix(cm: np.ndarray, path: PathLike, class_names: List[str]) -> None:
    """Rows True_<cls>, columns Predicted_<cls>."""
    cm = np.asarray(cm)
    _write_columns({f"Predicted_{n}": cm[:, j] for j, n in enumerate(class_names)}, path,
                   index=[f"True_{n}" for n in class_names])


def save_classification_report(y_true: np.ndarray, y_pred: np.ndarray, path: PathLike,
                               class_names: List[str]) -> Dict[str, object]:
    """Columns: Class, Precision, Recall, F1, Support (zero_division=0).
    Returns the columns."""
    pc = per_class_metrics(confusion_matrix(np.asarray(y_true), np.asarray(y_pred),
                                            len(class_names)))
    columns = {"Class": list(class_names), "Precision": np.asarray(pc["precision"]),
               "Recall": np.asarray(pc["recall"]), "F1": np.asarray(pc["f1"]),
               "Support": np.asarray(pc["support"]).astype(int)}
    _write_columns(columns, path)
    return columns


def save_overall_metrics(metrics: Dict[str, float], path: PathLike) -> None:
    _write_records([{"Metric": k, "Value": v} for k, v in metrics.items()], path)


def save_frequency_sensitivity(sensitivity_data: Dict[str, Dict[str, float]], path: PathLike,
                               baseline_accuracy: float, baseline_f1: float) -> None:
    _write_records([
        {
            "Band": band,
            "Masked_Accuracy": m["accuracy"],
            "Masked_F1": m["f1"],
            "Accuracy_Drop": baseline_accuracy - m["accuracy"],
            "F1_Drop": baseline_f1 - m["f1"],
        }
        for band, m in sensitivity_data.items()
    ], path)


def save_ibs_long_format(ibs_data: List[Dict], path: PathLike) -> None:
    """Columns: Subject_ID, True_Label, Pred_Label, Band, Feature, Channel_1,
    Channel_2, Value."""
    _write_records(ibs_data, path)


def save_ibs_matrix(matrix: np.ndarray, path: PathLike) -> None:
    """Headerless %.6f CxC matrix for MATLAB readmatrix()."""
    np.savetxt(path, np.asarray(matrix), delimiter=",", fmt="%.6f")


def save_channel_names(channel_names: List[str], path: PathLike) -> None:
    _write_columns({"Index": list(range(len(channel_names))),
                    "Channel_Name": list(channel_names)}, path)


def save_attention_summary(summary_data: List[Dict], path: PathLike) -> None:
    _write_records(summary_data, path)


def save_attention_matrix(matrix: np.ndarray, path: PathLike) -> None:
    np.savetxt(path, np.asarray(matrix), delimiter=",", fmt="%.6f")


def save_embedding_results(columns: Mapping[str, object], path: PathLike) -> None:
    """The columns (name -> numpy array or list), in order."""
    _write_columns(columns, path)


def save_gradcam_results(gradcam_matrix: np.ndarray, path: PathLike) -> None:
    np.savetxt(path, np.asarray(gradcam_matrix), delimiter=",", fmt="%.6f")


def save_gradcam_metadata(freq_axis: np.ndarray, time_axis: np.ndarray, path: PathLike,
                          sampling_rate: int = 256, n_fft: int = 128,
                          hop_length: int = 64) -> None:
    rows = [{"Axis": "Frequency_Hz", "Index": i, "Value": f} for i, f in enumerate(freq_axis)]
    rows += [{"Axis": "Time_Sec", "Index": i, "Value": t} for i, t in enumerate(time_axis)]
    rows += [
        {"Axis": "Param", "Index": "sampling_rate", "Value": sampling_rate},
        {"Axis": "Param", "Index": "n_fft", "Value": n_fft},
        {"Axis": "Param", "Index": "hop_length", "Value": hop_length},
    ]
    _write_records(rows, path)


def save_predictions(y_true: np.ndarray, y_pred: np.ndarray, y_prob: Optional[np.ndarray],
                     path: PathLike, class_names: List[str],
                     sample_ids: Optional[List] = None) -> None:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    columns = {
        "Sample_ID": sample_ids if sample_ids else list(range(len(y_true))),
        "True_Label": [class_names[int(y)] for y in y_true],
        "Pred_Label": [class_names[int(y)] for y in y_pred],
        "True_Label_ID": y_true,
        "Pred_Label_ID": y_pred,
        "Correct": (y_true == y_pred).astype(int),
    }
    if y_prob is not None:
        for i, name in enumerate(class_names):
            columns[f"Prob_{name}"] = y_prob[:, i]
    _write_columns(columns, path)
