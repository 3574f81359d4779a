"""Gaze model analysis: metrics, features/t-SNE, error analysis,
saliency, multi-model comparison.

    python -m eyegaze_tpu_torch.analyze_gaze [--model early|late] [--fusion-mode concat] \\
        [--checkpoint model.pt] [--tiny] [--compare kind:mode[:checkpoint] ...] [--device cpu]

The counterpart of the JAX package's ``scripts/analyze_gaze.py`` (the
reference's ``7_Analysis/python_scripts/analyze_gaze.py``): the same flags,
plus ``--device``, and the same files.  Quantitative (metrics, confusion
matrix, ROC), qualitative (CLS features, t-SNE) and error analysis
(per-pair accuracy, mechanism statistics), plus the ``--compare``
multi-model mode and its comparison table, significance tests and figures.
The data are the JAX script's synthetic gaze pairs (seed 42), ImageNet
normalized, every trial analysed.  A checkpoint is a port ``.pt`` (a
reference-named state_dict from ``train_gaze`` or
``scripts/export_torch_checkpoint.py``) with its ``.meta.json`` beside it,
read as ``serving.GazePredictor`` reads it; its meta's image size decides
tiny or full size, as in the JAX script.  Without one the model's weights
are drawn from seed 0.

It runs on the CUDA card unless ``--device cpu`` asks for the CPU, in
float32 with TF32 off.  ``analyze`` computes every number of a model on the
device (the forwards, the metrics, ROC, CLS features, the per-pair
accuracy, the mechanism statistics on the raw heatmaps, and saliency for
early fusion); every model's numbers, and the comparison's, are computed
before ``write`` writes anything.  The writers follow in the JAX script's
order: the CSVs, t-SNE (scikit-learn), the per-pair and mechanism tables
(pandas) and the figures (matplotlib); a missing package stops the run
with an ``ImportError`` naming it.  The ViT's attention is the plain one:
no kernel of the port launches.
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
    ErrorAnalyzer,
    MechanismAnalyzer,
    ModelResults,
    MultiModelComparator,
    extract_cls_features,
    input_saliency,
    tsne_embed,
)
from eyegaze_tpu_torch.data.image_fusion import imagenet_normalize
from eyegaze_tpu_torch.data.loader import ArrayDataset, batch_iterator
from eyegaze_tpu_torch.data.synthetic import synthetic_gaze_pair_dataset
from eyegaze_tpu_torch.models.vit import EarlyFusionViT, LateFusionViT
from eyegaze_tpu_torch.train.metrics import classification_metrics, roc_curves
from eyegaze_tpu_torch.train_dual_eeg import resolve_device
from eyegaze_tpu_torch.utils import io_csv

CLASS_NAMES = ["Single", "Competition", "Cooperation"]
BATCH = 16


def build_model(kind: str, fusion_mode: str, tiny: bool) -> torch.nn.Module:
    """The JAX script's model on the CPU, its weights drawn from seed 0."""
    kw = dict(num_classes=3, fusion_mode=fusion_mode, device=torch.device("cpu"),
              generator=torch.Generator().manual_seed(0))
    if tiny:
        kw.update(img_size=64, embed_dim=64, depth=2, num_heads=4)
    if kind == "early":
        return EarlyFusionViT(**kw)
    return LateFusionViT(**kw)


def load_model(kind: str, fusion_mode: str, tiny: bool, checkpoint=None) -> torch.nn.Module:
    """``kind``/``fusion_mode`` in eval mode on the CPU: from ``checkpoint``
    where given (its geometry read by ``serving.gaze_model``, the image size
    from its meta, else from ``tiny``), else ``build_model``'s."""
    if not checkpoint:
        return build_model(kind, fusion_mode, tiny).eval()
    state, meta = serving.load_checkpoint(checkpoint)
    config = meta.get("config", {})
    mc = config.get("model", {})
    mc = {**mc, "kind": kind, "fusion_mode": fusion_mode,
          "img_size": mc.get("img_size") or (64 if tiny else 224)}
    model, _ = serving.gaze_model(state, {**meta, "config": {**config, "model": mc}},
                                  torch.float32)
    model.load_state_dict(state, strict=True)
    return model.eval()


def validation_set(trials: int, tiny: bool) -> ArrayDataset:
    """The JAX script's synthetic pairs, ImageNet normalized, with the raw
    [0, 1] heatmaps beside them for the mechanism statistics (CoM/IoU),
    which are meaningless on normalized pixels."""
    img_size = 64 if tiny else 224
    data = synthetic_gaze_pair_dataset(n=trials, H=img_size, W=img_size, seed=42)
    img1 = imagenet_normalize(torch.from_numpy(data["img1"])).numpy()
    img2 = imagenet_normalize(torch.from_numpy(data["img2"])).numpy()
    return ArrayDataset({"img1": img1, "img2": img2, "label": data["label"],
                         "pair": data["pair"],
                         "raw1": np.asarray(data["img1"], np.float32),
                         "raw2": np.asarray(data["img2"], np.float32)})


def analyze(model: torch.nn.Module, kind: str, val_ds: ArrayDataset, device: torch.device
            ) -> dict:
    """Every number of one model: the forwards on ``device`` (float32, TF32
    off), then the metrics and statistics on the host; ``seconds`` holds
    each stage's wall time (forward, metrics, features, mechanism and, for
    early fusion, saliency)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _analyze(model.to(device).eval(), kind, val_ds, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _analyze(model, kind, val_ds, device) -> dict:
    seconds, clock = {}, [time.perf_counter()]

    def done(stage: str) -> None:
        # Each stage ends in a copy to the host: its device work has ended.
        now = time.perf_counter()
        seconds[stage], clock[0] = now - clock[0], now

    logits_all, labels_all = [], []
    with torch.inference_mode():
        for batch in batch_iterator(val_ds, BATCH):
            logits_all.append(model(torch.from_numpy(batch["img1"]).to(device),
                                    torch.from_numpy(batch["img2"]).to(device)).cpu().numpy())
            labels_all.append(batch["label"])
    logits = np.concatenate(logits_all)
    labels = np.concatenate(labels_all)
    preds = logits.argmax(axis=-1)
    probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    done("forward")
    out = {"logits": logits, "labels": labels, "preds": preds, "probs": probs,
           "metrics": classification_metrics(labels, preds),
           "roc": roc_curves(labels, probs)}
    done("metrics")
    out["features"] = extract_cls_features(model, batch_iterator(val_ds, BATCH))["features"]
    done("features")

    # Error analysis (per-pair) + gaze mechanism stats
    pairs = val_ds.arrays.get("pair")
    if pairs is not None:
        out["per_pair"] = ErrorAnalyzer(labels, preds, pairs).per_pair_accuracy()
    # Mechanism stats run on the RAW [0,1] heatmaps: after ImageNet
    # normalization the (dominant) background sits at ~-2, so the
    # intensity-weighted center of mass collapses toward the image centroid
    # for every sample and com_distance becomes meaningless.
    raw1 = val_ds.arrays.get("raw1", val_ds.arrays["img1"])
    raw2 = val_ds.arrays.get("raw2", val_ds.arrays["img2"])
    com = np.asarray([
        MechanismAnalyzer.com_distance(raw1[i], raw2[i])
        for i in range(len(val_ds))
    ])
    iou = np.asarray([
        MechanismAnalyzer.iou_overlap(raw1[i], raw2[i])
        for i in range(len(val_ds))
    ])
    out["mechanism"] = {
        "com_distance_vs_correct": MechanismAnalyzer.sensitivity_vs_correctness(
            com, labels == preds),
        "iou_vs_correct": MechanismAnalyzer.sensitivity_vs_correctness(iou, labels == preds),
        "com_per_class_tests": MechanismAnalyzer.per_class_tests(com, labels),
    }
    done("mechanism")

    # Saliency on a small sample (early-fusion models only, smoke check)
    if kind == "early":
        s1, _ = input_saliency(model, val_ds.arrays["img1"][:2], val_ds.arrays["img2"][:2])
        out["saliency"] = s1
        done("saliency")
    out["seconds"] = seconds
    return out


def write(numbers: dict, out_dir) -> None:
    """One model's files, in the JAX script's order."""
    import pandas as pd

    from eyegaze_tpu_torch.utils.visualizers import (
        plot_confusion_matrix,
        plot_embedding_scatter,
        plot_per_pair_accuracy,
        plot_roc_curves,
        setup_academic_style,
    )

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    setup_academic_style()
    labels, preds, probs, m = (numbers[k] for k in ("labels", "preds", "probs", "metrics"))

    # Quantitative
    io_csv.save_confusion_matrix(np.asarray(m["confusion_matrix"]),
                                 out_dir / "confusion_matrix.csv", CLASS_NAMES)
    io_csv.save_classification_report(labels, preds,
                                      out_dir / "classification_report.csv", CLASS_NAMES)
    io_csv.save_overall_metrics({k: float(v) for k, v in m.items() if np.ndim(v) == 0},
                                out_dir / "overall_metrics.csv")
    io_csv.save_predictions(labels, preds, probs, out_dir / "predictions.csv", CLASS_NAMES)
    plot_confusion_matrix(np.asarray(m["confusion_matrix"]), out_dir / "confusion_matrix.png")
    plot_roc_curves(numbers["roc"], out_dir / "roc_curves.png")

    # Qualitative: CLS features + t-SNE
    proj = tsne_embed(numbers["features"], perplexity=min(30.0, max(len(labels) - 1, 2)))
    plot_embedding_scatter(proj, labels, out_dir / "tsne_features.png")
    io_csv.save_embedding_results(
        {
            "Sample_ID": np.arange(len(proj)),
            "True_Label": [CLASS_NAMES[int(t)] for t in labels],
            "Pred_Label": [CLASS_NAMES[int(p)] for p in preds],
            "Dim_1": proj[:, 0], "Dim_2": proj[:, 1],
        },
        out_dir / "tsne_features.csv")

    if "per_pair" in numbers:
        per_pair = numbers["per_pair"]
        pd.DataFrame([{"Pair": p, "Accuracy": a} for p, a in per_pair.items()]).to_csv(
            out_dir / "per_pair_accuracy.csv", index=False)
        plot_per_pair_accuracy(per_pair, out_dir / "per_pair_accuracy.png")
    pd.DataFrame([{"Stat": k, **(v if isinstance(v, dict) else {"value": v})}
                  for k, v in numbers["mechanism"].items()
                  if isinstance(v, dict) and "t" in v]).to_csv(
        out_dir / "mechanism_stats.csv", index=False)

    if "saliency" in numbers:
        np.savetxt(out_dir / "saliency_sample.csv", numbers["saliency"][0], delimiter=",",
                   fmt="%.6f")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--model", choices=["early", "late"], default="early")
    ap.add_argument("--fusion-mode", default="concat")
    ap.add_argument("--checkpoint", default=None,
                    help="a port .pt state_dict; its meta is read from the same path with the "
                         "suffix .meta.json")
    ap.add_argument("--output-dir", default="runs/analysis_gaze")
    ap.add_argument("--trials", type=int, default=24)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--compare", nargs="*", default=None,
                    help="kind:fusion_mode[:checkpoint] specs to compare — "
                         "per-model trained checkpoints like the reference's "
                         "multi-model mode (run_analysis.py:22-101)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the CUDA card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)
    resolve_specs(args, ap.error)
    return args


def _meta_for(ckpt):
    """(tiny_or_None, fusion_mode_or_None) from the checkpoint's meta."""
    mc = serving.read_meta(ckpt).get("config", {}).get("model", {})
    tiny = (int(mc["img_size"]) < 224) if mc.get("img_size") else None
    return tiny, mc.get("fusion_mode")


def resolve_specs(args, error) -> None:
    """Sets ``args.specs``, the (kind, fusion_mode, checkpoint) to analyse,
    and ``args.tiny`` and ``args.fusion_mode`` from the checkpoints' metas,
    as the JAX script does: the exact model from the checkpoint's embedded
    config (reference analyze_gaze.py:150-230), or a tiny-run checkpoint
    would meet a ViT-B shape mismatch on loading."""
    if args.compare:
        # Resolve tiny PER SPEC (a one-way ratchet across specs would force
        # full-size checkpoints to be rebuilt tiny -> shape-mismatch crash).
        # Only specs whose checkpoint meta pins an img_size get a vote:
        # init-only specs have no inherent size and adopt the checkpointed
        # consensus (all compared models share one dataset, so pinned sizes
        # cannot mix 64 and 224).
        tiny_by_spec, specs = {}, []
        for spec in args.compare:
            parts = spec.split(":", 2)
            if len(parts) < 2:
                error(f"--compare spec {spec!r} must be kind:fusion_mode[:checkpoint]")
            kind, fm = parts[0], parts[1]
            ckpt = parts[2] if len(parts) > 2 else args.checkpoint
            tiny_by_spec[spec] = _meta_for(ckpt)[0] if ckpt else None
            specs.append((kind, fm, ckpt))
        pinned = {v for v in tiny_by_spec.values() if v is not None}
        if len(pinned) > 1:
            raise SystemExit(
                "--compare specs disagree on img_size (tiny 64 vs full 224) and "
                f"cannot share one dataset: {tiny_by_spec}")
        if pinned:
            args.tiny = next(iter(pinned))
        args.specs = specs
        return
    if args.checkpoint:
        t, fmode = _meta_for(args.checkpoint)
        if t is not None:
            args.tiny = t
        if fmode:
            args.fusion_mode = fmode
    args.specs = [(args.model, args.fusion_mode, args.checkpoint)]


def run(args) -> dict:
    """Every number, then every file.  Returns {'numbers': [one dict per
    spec], 'results': [ModelResults]}."""
    device = resolve_device(args.device, "eyegaze_tpu_torch.analyze_gaze")
    val_ds = validation_set(args.trials, args.tiny)
    numbers = []
    for kind, fm, ckpt in args.specs:
        model = load_model(kind, fm, args.tiny, ckpt)
        numbers.append(analyze(model, kind, val_ds, device))
        del model
    results = [ModelResults(f"{kind}_{fm}", n["labels"], n["preds"], n["probs"])
               for (kind, fm, _), n in zip(args.specs, numbers)]
    comp = MultiModelComparator(results)
    pairwise = comp.pairwise_rows() if args.compare else None

    if args.compare:
        for (kind, fm, _), n in zip(args.specs, numbers):
            write(n, Path(args.output_dir) / f"{kind}_{fm}")
        import pandas as pd

        comp.to_csv(Path(args.output_dir) / "comparison_table.csv")
        pd.DataFrame(pairwise).to_csv(
            Path(args.output_dir) / "pairwise_significance.csv", index=False)
        # Full comparison figure suite (model_comparison.py:249-513 role).
        comp.plot_all(Path(args.output_dir) / "comparison_figures")
        print(comp.metric_table().to_string(index=False))
    else:
        write(numbers[0], args.output_dir)
    print(f"[analyze_gaze] done -> {args.output_dir}")
    return {"numbers": numbers, "results": results}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
