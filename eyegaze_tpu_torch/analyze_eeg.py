"""EEG model analysis: metrics, frequency sensitivity, IBS connectivity,
embeddings, attention, Grad-CAM.

    python -m eyegaze_tpu_torch.analyze_eeg --checkpoint best_model.pt \\
        [--analyses metrics,frequency,ibs,embedding,attention,gradcam|all] [--device cpu]

The counterpart of the JAX package's ``scripts/analyze_eeg.py``: the same
flags, defaults, stages and MATLAB-facing CSV tree (``utils/io_csv``).  The
checkpoint is a port ``.pt`` (a reference-named state_dict: from
``python -m eyegaze_tpu_torch.import_torch_checkpoint``, ``train_dual_eeg``
or ``scripts/export_torch_checkpoint.py``) with its ``.meta.json`` beside
it; the model is rebuilt in float32 with the geometry and ablation the
served ``Predictor.from_checkpoint`` reads (``serving.dual_eeg_config``),
the flags filling in where the meta is silent.  Without a checkpoint it
runs a model drawn from seed 0 (smoke mode).  The data are the synthetic
pairs and the validation split of the JAX script.

It runs on the CUDA card unless ``--device cpu`` asks for the CPU, in full
float32 (TF32 off).  Every analysed forward launches K1 once on the card.
The embedding stage needs scikit-learn, which the card's host may lack; it
then stops with an ``ImportError`` naming it.  ``--render-figures`` renders
the MATLAB figure suites and the grouped frequency-sensitivity bar from the
CSVs (``analysis/matlab_parity``) after every number has been computed and
written; it needs pandas and matplotlib, and stops with an ``ImportError``
naming the one that is missing.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch import serving
from eyegaze_tpu_torch.analysis import (
    BAND_NAMES,
    FEATURE_NAMES,
    STANDARD_32_CHANNELS,
    extract_attention_maps,
    extract_embeddings,
    extract_ibs_matrices,
    frequency_sensitivity,
    gradcam_spectrogram,
    render_all_suites,
    render_frequency_sensitivity_bar,
    run_inference,
    tsne_embed,
    umap_embed,
)
from eyegaze_tpu_torch.data.loader import DualEEGWindowDataset
from eyegaze_tpu_torch.data.metadata import stratified_split
from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.ops.connectivity import feature_indices_for
from eyegaze_tpu_torch.train.metrics import classification_metrics, roc_curves
from eyegaze_tpu_torch.train_dual_eeg import resolve_device
from eyegaze_tpu_torch.utils import io_csv

CLASS_NAMES = ["Single", "Competition", "Cooperation"]
ALL_ANALYSES = ("metrics", "frequency", "ibs", "embedding", "attention", "gradcam")
INFERENCE_STAGES = {"metrics", "frequency", "embedding"}


def load_model(args, device: torch.device) -> tuple[DualEEGTransformer, dict]:
    """(float32 model in eval mode on ``device``, its constructor fields).
    With a checkpoint, the fields are ``serving.dual_eeg_config``'s reading
    of its meta, the flags standing in where the meta is silent; without
    one, the flags' model drawn from seed 0."""
    flags = dict(in_channels=args.channels, d_model=args.d_model, num_layers=args.num_layers,
                 num_heads=args.num_heads, d_ff=args.d_ff, sampling_rate=args.fs)
    state = None
    if args.checkpoint:
        state, meta = serving.load_checkpoint(args.checkpoint)
        kw = serving.dual_eeg_config(meta, state, **flags)
    else:
        kw = dict(flags, max_len=max(args.window // 4, 256))
    model = DualEEGTransformer(**kw, device=torch.device("cpu"),
                               generator=torch.Generator().manual_seed(0))
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.to(device).eval(), kw


def make_batches(args):
    """A function returning a fresh iterator over the validation windows'
    batches: the JAX script's synthetic pairs (seed 42) and split."""
    data = synthetic_eeg_pair_dataset(n=args.trials, C=args.channels,
                                      T=max(args.window, 1024), fs=args.fs, seed=42)
    idx = list(range(len(data["label"])))
    _, val_idx = stratified_split(idx, data["label"], test_size=0.2, seed=42)
    val_idx = np.asarray(val_idx)
    ds = DualEEGWindowDataset(data["eeg1"][val_idx], data["eeg2"][val_idx],
                              data["label"][val_idx], window_size=args.window,
                              stride=args.window // 2, pairs=data["pair"][val_idx])
    return lambda: ds.iter_batches(args.batch_size)


def planned_forwards(analyses, kw: dict, batch_labels, num_classes: int = 3) -> dict:
    """The model forwards each stage runs, from the batches (their labels)
    and the stages: one a batch for the inference (which metrics, frequency
    and embedding share), the IBS and the attention stages; six a batch for
    the frequency stage; one a batch holding a class for Grad-CAM (its
    classes share that forward's graph).  On the card each forward of a
    model with the robust IBS tokens launches K1 once."""
    batches = [np.asarray(b) for b in batch_labels]
    n = len(batches)
    use_ibs = kw.get("use_ibs", True)
    plan = {
        "inference": n if INFERENCE_STAGES & set(analyses) else 0,
        "frequency": len(BAND_NAMES) * n if "frequency" in analyses and use_ibs else 0,
        "ibs": n if "ibs" in analyses and use_ibs else 0,
        "attention": n if "attention" in analyses and kw.get("use_cross_attention", True) else 0,
        "gradcam": (sum(int((b < num_classes).any()) for b in batches)
                    if "gradcam" in analyses and kw.get("use_spectrogram", True) else 0),
    }
    return {k: v for k, v in plan.items() if v}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--checkpoint", default=None,
                    help="a port .pt state_dict; its meta is read from the same path with the "
                         "suffix .meta.json")
    ap.add_argument("--output-dir", default="runs/analysis_eeg")
    ap.add_argument("--analyses", default="all")
    ap.add_argument("--trials", type=int, default=24)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--fs", type=float, default=256.0)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--num-layers", type=int, default=6)
    ap.add_argument("--num-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--render-figures", action="store_true",
                    help="after exporting CSVs, render the MATLAB figure "
                         "suites natively (analysis/matlab_parity.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the CUDA card; 'cpu' must be asked for)")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Runs the analyses; returns {'stages': {name: {'seconds', 'forwards'}},
    'planned': planned_forwards(...), 'batches': int}."""
    device = resolve_device(args.device, "eyegaze_tpu_torch.analyze_eeg")
    analyses = ALL_ANALYSES if args.analyses == "all" else tuple(args.analyses.split(","))
    unknown = sorted(set(analyses) - set(ALL_ANALYSES))
    if unknown:
        raise SystemExit(f"unknown analyses {unknown}; choose from {', '.join(ALL_ANALYSES)}")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(args, analyses, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _run(args, analyses, device: torch.device) -> dict:
    model, kw = load_model(args, device)
    if not args.checkpoint:
        print("[analyze_eeg] no checkpoint: using random init (smoke mode)")
    batches_fn = make_batches(args)
    dirs = io_csv.ensure_output_dirs(args.output_dir)
    batch_labels = [b["label"] for b in batches_fn()]
    plan = planned_forwards(analyses, kw, batch_labels)
    stages: dict = {}
    clock = [time.perf_counter()]

    def done(stage: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stages[stage] = {"seconds": now - clock[0], "forwards": plan.get(stage, 0)}
        clock[0] = now
        print(f"[analyze_eeg] {stage}: {stages[stage]['seconds']:.3f} s, "
              f"{stages[stage]['forwards']} forwards")

    labels = preds = probs = baseline = inference = None
    if INFERENCE_STAGES & set(analyses):
        inference = run_inference(model, batches_fn())
        labels, preds, probs = inference["labels"], inference["preds"], inference["probs"]
        baseline = classification_metrics(labels, preds)
        done("inference")

    if "metrics" in analyses:
        print("[analyze_eeg] core metrics")
        io_csv.save_confusion_matrix(baseline["confusion_matrix"],
                                     dirs["core_metrics"] / "confusion_matrix.csv", CLASS_NAMES)
        io_csv.save_classification_report(labels, preds,
                                          dirs["core_metrics"] / "classification_report.csv",
                                          CLASS_NAMES)
        io_csv.save_overall_metrics(
            {k: float(v) for k, v in baseline.items() if np.ndim(v) == 0},
            dirs["core_metrics"] / "overall_metrics.csv")
        io_csv.save_predictions(labels, preds, probs, dirs["core_metrics"] / "predictions.csv",
                                CLASS_NAMES)
        roc = roc_curves(labels, probs)
        io_csv.save_overall_metrics({"macro_auc": roc["macro_auc"], "micro_auc": roc["micro"]["auc"]},
                                    dirs["core_metrics"] / "roc_auc.csv")
        done("metrics")

    if "frequency" in analyses and kw.get("use_ibs", True):
        print("[analyze_eeg] frequency sensitivity")
        sens = frequency_sensitivity(model.with_mask_band, batches_fn)
        io_csv.save_frequency_sensitivity(
            sens, dirs["frequency_sensitivity"] / "band_sensitivity.csv",
            float(baseline["accuracy"]), float(baseline["f1_macro"]))
        done("frequency")

    if "ibs" in analyses and kw.get("use_ibs", True):
        print("[analyze_eeg] IBS connectivity export")
        ibs = extract_ibs_matrices(model, batches_fn())
        chans = STANDARD_32_CHANNELS[: args.channels]
        io_csv.save_channel_names(chans, dirs["ibs_connectivity"] / "channel_names.csv")
        # The model's features only: a 'phase' or 'amplitude' model has 4 or 3.
        feats = [FEATURE_NAMES[i] for i in feature_indices_for(kw.get("ibs_feature_type", "all"))]
        for ci, cname in enumerate(CLASS_NAMES):
            for bi, band in enumerate(BAND_NAMES):
                for fi, feat in enumerate(feats):
                    io_csv.save_ibs_matrix(ibs["class_means"][ci, bi, fi],
                                           dirs["ibs_mean_by_class"] / f"{cname}_{band}_{feat}.csv")
        for bi, band in enumerate(BAND_NAMES):
            for fi, feat in enumerate(feats):
                io_csv.save_ibs_matrix(ibs["diff_coop_vs_comp"][bi, fi],
                                       dirs["ibs_difference"] / f"diff_{band}_{feat}.csv")
        done("ibs")

    if "embedding" in analyses:
        print("[analyze_eeg] embeddings")
        for name, feats in extract_embeddings(inference).items():
            proj = tsne_embed(feats, perplexity=min(30.0, max(len(feats) - 1, 2)))
            columns = {
                "Sample_ID": np.arange(len(proj)),
                "True_Label": [CLASS_NAMES[int(t)] for t in labels],
                "Pred_Label": [CLASS_NAMES[int(p)] for p in preds],
                "Dim_1": proj[:, 0], "Dim_2": proj[:, 1],
            }
            io_csv.save_embedding_results(columns, dirs["feature_embeddings"] / f"tsne_{name}.csv")
            uproj = umap_embed(feats)
            if uproj is not None:
                columns.update(Dim_1=uproj[:, 0], Dim_2=uproj[:, 1])
                io_csv.save_embedding_results(columns,
                                              dirs["feature_embeddings"] / f"umap_{name}.csv")
        done("embedding")

    if "attention" in analyses and kw.get("use_cross_attention", True):
        print("[analyze_eeg] attention maps")
        att = extract_attention_maps(model, batches_fn())
        io_csv.save_attention_matrix(att["mean_map"],
                                     dirs["attention_weights"] / "mean_attention.csv")
        summary = []
        for ci, cname in enumerate(CLASS_NAMES):
            m = att["class_means"][ci]
            io_csv.save_attention_matrix(m, dirs["attention_mean_by_class"]
                                         / f"attention_{cname}.csv")
            diag = np.diagonal(m)
            off = m[~np.eye(m.shape[0], dtype=bool)]
            summary.append({
                "Class": cname,
                "Mean_Diagonal": float(diag.mean()), "Std_Diagonal": float(diag.std()),
                "Mean_OffDiag": float(off.mean()), "Std_OffDiag": float(off.std()),
            })
        io_csv.save_attention_summary(summary,
                                      dirs["attention_weights"] / "attention_summary.csv")
        done("attention")

    if "gradcam" in analyses and kw.get("use_spectrogram", True):
        print("[analyze_eeg] Grad-CAM")
        cams = gradcam_spectrogram(model, batches_fn(), out_size=64)
        for ci, cname in enumerate(CLASS_NAMES):
            io_csv.save_gradcam_results(cams[ci], dirs["gradcam_mean_by_class"]
                                        / f"gradcam_{cname}.csv")
        freq_axis = np.linspace(0, args.fs / 2, 64)
        time_axis = np.linspace(0, args.window / args.fs, 64)
        io_csv.save_gradcam_metadata(freq_axis, time_axis, dirs["gradcam"] / "gradcam_metadata.csv",
                                     int(args.fs))
        done("gradcam")

    if args.render_figures:
        print("[analyze_eeg] rendering MATLAB figure suites natively")
        rendered = render_all_suites(args.output_dir,
                                     Path(args.output_dir) / "figures")
        for suite, artifacts in rendered.items():
            print(f"[analyze_eeg]   {suite}: {len(artifacts)} artifacts")
        band_csv = dirs["frequency_sensitivity"] / "band_sensitivity.csv"
        if band_csv.exists():  # analyze_eeg.m:269-341 grouped-bar figure
            render_frequency_sensitivity_bar(
                band_csv, Path(args.output_dir) / "figures" /
                "freq_sensitivity_grouped_bar.png")
            print("[analyze_eeg]   frequency_sensitivity: 1 artifact")
        done("figures")

    print(f"[analyze_eeg] done -> {args.output_dir}")
    return {"stages": stages, "planned": plan, "batches": len(batch_labels)}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
