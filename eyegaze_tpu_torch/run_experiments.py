"""Ablation sweep runner — 13 experiments in 3 categories (A/B/C).

The counterpart of the repository's ``run_experiments.py`` (the reference's
matrix at :47-233): it copies the base YAML, patches its ablation and
training sections, writes one config per experiment, and launches
``python -m eyegaze_tpu_torch.train_dual_eeg`` on it, one subprocess per
experiment.  Each trains on the card unless its config's ``system.device``
says ``cpu``.

    python -m eyegaze_tpu_torch.run_experiments --list
    python -m eyegaze_tpu_torch.run_experiments --dry-run --experiments A
    python -m eyegaze_tpu_torch.run_experiments --experiments A,B,C [--names A5_full_model ...]
    python -m eyegaze_tpu_torch.run_experiments --yes --epochs 2 [--mesh dp]

``--mesh`` is passed through to every run (data parallelism over the cards).

Reading and writing the YAML files needs PyYAML.
"""

from __future__ import annotations

import argparse
import copy
import subprocess
import sys
import time
from pathlib import Path

from eyegaze_tpu_torch.config import config_from_dict, load_yaml_config, save_yaml_config

PROJECT_ROOT = Path(__file__).resolve().parent.parent
CONFIG_PATH = PROJECT_ROOT / "configs" / "dual_eeg_transformer.yaml"
OUTPUT_DIR = PROJECT_ROOT / "runs" / "ablation_studies_torch"

_COMMON = dict(ibs_mode="robust", ibs_instance_norm=True, ibs_feature_type="all",
               use_cross_attention=True)

# Experiment matrix (parity with reference run_experiments.py:47-233).
EXPERIMENTS = {
    # ===== A. Feature contribution =====
    "A1_baseline_temporal_only": {
        "description": "Baseline: Temporal Conv Only (no Spectrogram, no IBS)",
        "category": "A",
        "ablation": {**_COMMON, "use_spectrogram": False, "use_ibs": False},
        "training": {},
    },
    "A2_plus_spectrogram": {
        "description": "+ Spectrogram (no IBS)",
        "category": "A",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": False},
        "training": {},
    },
    "A3_plus_ibs_scalar": {
        "description": "+ IBS (Old/Scalar, 1 token)",
        "category": "A",
        "ablation": {**_COMMON, "use_spectrogram": False, "use_ibs": True,
                     "ibs_mode": "scalar"},
        "training": {},
    },
    "A4_plus_ibs_robust": {
        "description": "+ IBS (New/Robust Matrix, 42 tokens)",
        "category": "A",
        "ablation": {**_COMMON, "use_spectrogram": False, "use_ibs": True},
        "training": {},
    },
    "A5_full_model": {
        "description": "Full Model (Spectrogram + Robust IBS)",
        "category": "A",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True},
        "training": {},
    },
    # ===== B. IBS tokenizer design =====
    "B1_no_instance_norm": {
        "description": "No Instance Normalization in RobustIBSTokenizer",
        "category": "B",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True,
                     "ibs_instance_norm": False},
        "training": {},
    },
    "B2_phase_only": {
        "description": "Phase-based features only (PLV, PLI, wPLI, Phase_Diff) - 24 tokens",
        "category": "B",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True,
                     "ibs_feature_type": "phase"},
        "training": {},
    },
    "B3_amplitude_only": {
        "description": "Amplitude-based features only (Coherence, Power_Corr, Time_Corr) - 18 tokens",
        "category": "B",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True,
                     "ibs_feature_type": "amplitude"},
        "training": {},
    },
    "B4_full_ibs_baseline": {
        "description": "Full IBS (all 7 features) - baseline for B",
        "category": "B",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True},
        "training": {},
    },
    # ===== C. Interaction & loss =====
    "C1_no_cross_attention": {
        "description": "No Cross-Brain Attention",
        "category": "C",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True,
                     "use_cross_attention": False},
        "training": {},
    },
    "C2_no_contrastive_loss": {
        "description": "No IBS contrastive loss",
        "category": "C",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True},
        "training": {"use_ibs_contrastive": False, "lambda_ibs_contrastive": 0.0},
    },
    "C3_no_ibs_cls_loss": {
        "description": "No IBS classification-head loss",
        "category": "C",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True},
        "training": {"use_ibs_cls_loss": False, "lambda_ibs_cls": 0.0},
    },
    "C4_full_losses_baseline": {
        "description": "Full model with all losses - baseline for C",
        "category": "C",
        "ablation": {**_COMMON, "use_spectrogram": True, "use_ibs": True},
        "training": {"use_ibs_contrastive": True, "use_ibs_cls_loss": True,
                     "lambda_ibs_contrastive": 0.3, "lambda_ibs_cls": 1.0},
    },
}


def create_experiment_config(base: dict, name: str, exp: dict, extra_training: dict) -> dict:
    cfg = copy.deepcopy(base)
    cfg.setdefault("ablation", {}).update(exp["ablation"])
    cfg.setdefault("training", {}).update(exp["training"])
    cfg["training"].update(extra_training)
    cfg["training"]["output_dir"] = str(OUTPUT_DIR / name)
    cfg.setdefault("wandb", {})["run_name"] = name
    return cfg


def filter_experiments(categories, names):
    out = {}
    for name, exp in EXPERIMENTS.items():
        if names and name not in names:
            continue
        if categories and exp["category"] not in categories:
            continue
        out[name] = exp
    return out


def run_experiment(name: str, config_path: Path, dry_run: bool = False,
                   mesh: str | None = None) -> bool:
    cmd = [sys.executable, "-m", "eyegaze_tpu_torch.train_dual_eeg", "--config",
           str(config_path)]
    if mesh:
        cmd += ["--mesh", mesh]
    print(f"[run_experiments] {name}: {' '.join(cmd)}", flush=True)
    if dry_run:
        return True
    return subprocess.run(cmd, cwd=PROJECT_ROOT).returncode == 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--experiments", default=None,
                    help="comma-separated categories, e.g. A,B,C")
    ap.add_argument("--names", nargs="*", default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--yes", action="store_true", help="skip interactive confirm")
    ap.add_argument("--config", default=str(CONFIG_PATH))
    ap.add_argument("--epochs", type=int, default=None, help="override epochs (smoke runs)")
    ap.add_argument("--mesh", nargs="?", const="dp", default=None,
                    help="device-mesh spec passed through to every training "
                         "run: 'dp' = data-parallel over all local devices; "
                         "'dpN,tpM' adds a tensor-parallel model axis")
    args = ap.parse_args(argv)

    if args.list:
        for name, exp in EXPERIMENTS.items():
            print(f"  [{exp['category']}] {name}: {exp['description']}")
        return 0

    cats = args.experiments.split(",") if args.experiments else None
    selected = filter_experiments(cats, args.names)
    if not selected:
        print("no experiments selected")
        return 1

    print(f"Selected {len(selected)} experiments:")
    for name, exp in selected.items():
        print(f"  [{exp['category']}] {name}: {exp['description']}")
    if not args.yes and not args.dry_run and sys.stdin.isatty():
        if input("Proceed? [y/N] ").strip().lower() != "y":
            return 1

    base = load_yaml_config(args.config).raw
    extra_training = {}
    if args.epochs is not None:
        extra_training["num_train_epochs"] = args.epochs

    cfg_dir = OUTPUT_DIR / "configs"
    cfg_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    t0 = time.time()
    for name, exp in selected.items():
        cfg_path = cfg_dir / f"{name}.yaml"
        save_yaml_config(config_from_dict(create_experiment_config(base, name, exp,
                                                                   extra_training)), cfg_path)
        ok = run_experiment(name, cfg_path, dry_run=args.dry_run, mesh=args.mesh)
        results[name] = ok
        if not ok:
            print(f"[run_experiments] {name} FAILED; continuing")
    dt = time.time() - t0
    print(f"\n=== Summary ({dt:.0f}s) ===")
    for name, ok in results.items():
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
