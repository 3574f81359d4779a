"""Full-scale synthetic rehearsal: the whole reference workflow at the dataset's volume.

The counterpart of ``scripts/rehearsal_full_scale.py``:

    python -m eyegaze_tpu_torch.rehearsal_full_scale [--root runs/rehearsal] \
        [--trials 4463] [--csv-trials 100] [--jpg-trials 112] [--features-trials 64] \
        [--eeg-epochs 1] [--gaze-epochs 1] \
        [--stages gen,convert,windows,features,train,analyze] [--device cpu]

It generates a reference-shaped dataset under ``--root``: 4,463 trials
over the 28 real pairs (12-40 without 18) in the real class ratios
(Single 2,233 / Competition 1,112 / Cooperation 1,118), split by pair into
3,187 train (pairs 12-32) and 1,276 validation trials (pairs 33-40), as a
raw (32, 3250) float32 volume, a subset of reference-format CSVs and a
subset of 3000 x 1583 heatmap JPGs.  Then it drives every stage once and
writes ``rehearsal_report.json``: per step its wall seconds and the keys
of the JAX script's report, plus the process's peak RSS so far
(``peak_rss_gib``) and K1's launches in the step (``k1_launches``).

``--stages`` takes the JAX script's stage names, each standing for its
steps, and the steps' own names (the report's keys):

    gen       gen_metadata, gen_eeg_volume, gen_csv_subset, gen_jpg_subset
    convert   convert_eeg_csv (+ the CSV round trip), convert_gaze_jpg
    windows   windows_full (window 1024, stride 256, pair split)
    features  extract_features (the first --features-trials trials)
    train     train_eeg_full_windows (the flagship at full width, batch
              128, one launch of K1 per train step and eval batch),
              train_gaze_converted (ViT-B/16 early fusion, batch 16)
    analyze   analyze_entropy_real_files, analyze_eeg_ckpt (K1 once per
              analysed forward)

Each step calls its entry point's ``main`` in this process (one CUDA
context, one build of the kernels); a non-zero return or an exception
stops the run.  The windows, features, train and analyze steps run on
the CUDA card unless ``--device cpu`` asks for the CPU; without a card the
rehearsal stops with a message before it writes anything.  The JPG steps,
``convert_gaze_jpg`` and the gaze half of ``analyze_entropy`` need PIL,
``analyze_entropy``'s tables and figures need pandas and matplotlib: a
step whose package is missing stops the run with an ``ImportError`` naming
it, so on a host without them leave those steps out of ``--stages``.

Two things differ from the JAX script on purpose: a train step that ran
and left no ``best_model.pt``, and an ``analyze_eeg_ckpt`` without one,
stop the run and name the file (the JAX script skips the analysis
silently), and the gaze run trains into ``<root>/gaze_run`` (the JAX
script trains into the YAML's shared ``runs/gaze_earlyfusion``, where an
earlier run's better F1 keeps its stale best model).
"""

from __future__ import annotations

import argparse
import json
import math
import resource
import shutil
import sys
import time
from pathlib import Path

import numpy as np

from eyegaze_tpu_torch import (
    analyze_eeg,
    analyze_entropy,
    convert_gaze_images,
    extract_eeg_features,
    preprocess_eeg_raw,
    preprocess_eeg_windows,
    train_dual_eeg,
    train_gaze,
)
from eyegaze_tpu_torch.config import load_yaml_config
from eyegaze_tpu_torch.data.metadata import LABEL2ID, verify_metadata
from eyegaze_tpu_torch.data.windows import window_index
from eyegaze_tpu_torch.kernels import phase_metrics
from eyegaze_tpu_torch.train_dual_eeg import resolve_device

REPO = Path(__file__).resolve().parent.parent

# Reference dataset constants (complete_metadata.json, experiments_list.md).
CLASS_COUNTS = {"Single": 2233, "Competition": 1112, "Cooperation": 1118}
TRAIN_PAIRS = [p for p in range(12, 33) if p != 18]  # 20 pairs
VAL_PAIRS = list(range(33, 41))  # 8 pairs
N_TRAIN, N_VAL = 3187, 1276
FULL_TRIALS = N_TRAIN + N_VAL
FULL_WINDOWS = (28683, 11484)  # train, val at FULL_TRIALS
C, T_RAW = 32, 3250
FS, WINDOW, STRIDE = 256, 1024, 256
JPG_H, JPG_W = 1583, 3000  # PIL size=(W,H) -> native 3000x1583 images

# The train steps' recipes: the JAX script's YAML for the flagship and its
# gaze flags.  Module values, so that a test can narrow them.
EEG_MODEL = {"in_channels": 32, "num_labels": 3, "d_model": 256, "num_layers": 6,
             "num_heads": 8, "d_ff": 1024}
EEG_BATCH = 128
EEG_ABLATION: dict = {}  # an ablation section for the YAML (none: the JAX script's)
GAZE_CONFIG = REPO / "configs" / "gaze_earlyfusion.yaml"
GAZE_BATCH = 16
GAZE_SIZE = 224  # convert_gaze_images' --size: the ViT's img_size
GAZE_FLAGS: tuple = ()  # more train_gaze flags

STAGES = {
    "gen": ("gen_metadata", "gen_eeg_volume", "gen_csv_subset", "gen_jpg_subset"),
    "convert": ("convert_eeg_csv", "convert_gaze_jpg"),
    "windows": ("windows_full",),
    "features": ("extract_features",),
    "train": ("train_eeg_full_windows", "train_gaze_converted"),
    "analyze": ("analyze_entropy_real_files", "analyze_eeg_ckpt"),
}
STEPS = tuple(s for steps in STAGES.values() for s in steps)
K1_STEPS = ("train_eeg_full_windows", "analyze_eeg_ckpt")  # the steps that launch K1


def _stem(pair: int, cls: str, trial: int, player_idx: int) -> str:
    """Reference-convention file stem (analyze_entropy.py:110-179)."""
    if cls == "Single":
        ab = "A" if player_idx == 0 else "B"
        role = "player" if player_idx == 0 else "observer"
        return f"Pair-{pair}-{ab}-Single-EYE_trial{trial}_{role}"
    tag = "Comp" if cls == "Competition" else "Coop"
    return f"Pair-{pair}-{tag}-EYE_trial{trial}_player{'A' if player_idx == 0 else 'B'}"


def build_metadata(n_trials: int):
    """Distribute ``n_trials`` with the real class ratios over the real pairs
    so the pair split reproduces the reference's 3,187/1,276 trial counts."""
    scale = n_trials / sum(CLASS_COUNTS.values())
    counts = {k: round(v * scale) for k, v in CLASS_COUNTS.items()}
    counts["Single"] += n_trials - sum(counts.values())  # exact total
    n_train = round(N_TRAIN * scale)

    # Interleave classes so every pair sees all three.
    classes = []
    for cls, n in counts.items():
        classes += [cls] * n
    rng = np.random.default_rng(42)
    rng.shuffle(classes)

    records = []
    trial_no = {}
    for i, cls in enumerate(classes):
        if i < n_train:
            pair = TRAIN_PAIRS[i % len(TRAIN_PAIRS)]
        else:
            pair = VAL_PAIRS[i % len(VAL_PAIRS)]
        key = (pair, cls)
        trial_no[key] = trial_no.get(key, 0) + 1
        t = trial_no[key]
        records.append({
            "pair": pair,
            "player1": _stem(pair, cls, t, 0),
            "player2": _stem(pair, cls, t, 1),
            "class": cls,
            "formal_sen": float(rng.uniform(1, 7)),
            "lively_sen": float(rng.uniform(1, 7)),
        })
    return records


def expected_windows(meta) -> tuple[int, int, int, int]:
    """(train trials, val trials, train windows, val windows) of the pair
    split: every trial is T_RAW samples, cut at WINDOW / STRIDE."""
    n_train = sum(1 for m in meta if m["pair"] not in VAL_PAIRS)
    n_val = len(meta) - n_train
    return (n_train, n_val, *(len(window_index([T_RAW] * n, WINDOW, STRIDE))
                              for n in (n_train, n_val)))


def gen_eeg_volume(meta, out_dir: Path, chunk: int = 256):
    """Unsplit raw-trial npy volume at full scale, written via memmap."""
    out_dir.mkdir(parents=True, exist_ok=True)
    n = len(meta)
    labels = np.asarray([LABEL2ID[m["class"]] for m in meta], np.int32)
    pairs = np.asarray([m["pair"] for m in meta], np.int32)
    e1 = np.lib.format.open_memmap(out_dir / "eeg1.npy", mode="w+",
                                   dtype=np.float32, shape=(n, C, T_RAW))
    e2 = np.lib.format.open_memmap(out_dir / "eeg2.npy", mode="w+",
                                   dtype=np.float32, shape=(n, C, T_RAW))
    rng = np.random.default_rng(7)
    t = np.arange(T_RAW, dtype=np.float32) / 256.0
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        # Class-conditioned base rhythm (8/10/12 Hz) + pink-ish noise so the
        # training stage sees learnable class structure, like data/synthetic.
        freq = 8.0 + 2.0 * labels[s:s + m, None, None]
        base = np.sin(2 * np.pi * freq * t[None, None, :]
                      + rng.uniform(0, 2 * np.pi, (m, C, 1)))
        e1[s:s + m] = base + rng.normal(0, 0.8, (m, C, T_RAW))
        e2[s:s + m] = base * (0.5 + 0.5 * (labels[s:s + m, None, None] == 2)) \
            + rng.normal(0, 0.8, (m, C, T_RAW))
    e1.flush()
    e2.flush()
    np.save(out_dir / "labels.npy", labels)
    np.save(out_dir / "pairs.npy", pairs)
    return n


def gen_csv_subset(meta, csv_dir: Path, eeg_dir: Path, n_csv: int):
    """First ``n_csv`` trials as real-size (32 x 3250) reference-format CSVs."""
    csv_dir.mkdir(parents=True, exist_ok=True)
    e1 = np.load(eeg_dir / "eeg1.npy", mmap_mode="r")
    e2 = np.load(eeg_dir / "eeg2.npy", mmap_mode="r")
    for i, m in enumerate(meta[:n_csv]):
        for stem, arr in ((m["player1"], e1[i]), (m["player2"], e2[i])):
            rows = [",".join(f"{v:.4f}" for v in row) for row in np.asarray(arr)]
            (csv_dir / f"{stem}.csv").write_text("\n".join(rows) + "\n")
    return n_csv * 2


def jpg_subset(meta, n_jpg: int):
    """First trials are all train pairs (build_metadata order), so mix in a
    tail of val-pair trials or the gaze train stage has an empty val split.
    Needs n_jpg >= 2: one train-pair head + one val-pair tail minimum."""
    if n_jpg < 2:
        raise ValueError(f"--jpg-trials must be >= 2 (got {n_jpg}): the gaze "
                         "stage needs at least one train-pair and one "
                         "val-pair trial")
    n_val = max(min(16, n_jpg // 4), 1)
    return meta[: n_jpg - n_val] + meta[-n_val:]


def gen_jpg_subset(meta, jpg_dir: Path, n_jpg: int):
    """Full-resolution 3000x1583 class-conditioned heatmap JPGs."""
    from PIL import Image

    from eyegaze_tpu_torch.data.synthetic import synthetic_gaze_heatmap

    jpg_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    for m in jpg_subset(meta, n_jpg):
        label = LABEL2ID[m["class"]]
        for stem in (m["player1"], m["player2"]):
            # Generate at 1/4 scale, upsample to native size: the heatmaps are
            # smooth blobs, and this keeps generation CPU-bounded while the
            # JPEG files are real 3000x1583 inputs for decode/resize stages.
            small = synthetic_gaze_heatmap(label, H=JPG_H // 4, W=JPG_W // 4, rng=rng)
            img = (np.transpose(small, (1, 2, 0)) * 255).astype(np.uint8)
            Image.fromarray(img).resize((JPG_W, JPG_H), Image.BILINEAR).save(
                jpg_dir / f"{stem}.jpg", quality=90)
    return n_jpg * 2


def call(module, argv, entry=None):
    """``module.main(argv)`` (or ``entry(argv)``) in this process; its
    result.  A non-zero exit code stops the run."""
    argv = [str(a) for a in argv]
    print(f"  $ python -m {module.__name__} {' '.join(argv)}")
    out = (entry or module.main)(argv)
    if isinstance(out, int) and out != 0:
        raise RuntimeError(f"stage failed: {module.__name__} (rc={out})")
    return out


def require(path: Path, what: str) -> None:
    if not path.exists():
        raise RuntimeError(f"{what} left no {path}")


def peak_rss_gib() -> float:
    """The process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def eeg_train_yaml(win_dir: Path, output_dir: Path, epochs: int) -> str:
    """The flagship's training config: the JAX script's YAML (with
    EEG_ABLATION's section, when it has one)."""
    model = ", ".join(f"{k}: {v}" for k, v in EEG_MODEL.items())
    data = (f"eeg_base_path: {win_dir}, window_size: {WINDOW}, stride: {WINDOW}, "
            f"sampling_rate: {float(FS)}")
    ablation = ", ".join(f"{k}: {v}" for k, v in EEG_ABLATION.items())
    return (f"ablation: {{{ablation}}}" if EEG_ABLATION else "") + f"""
model: {{{model}}}
data: {{{data}}}
training:
  output_dir: {output_dir}
  num_train_epochs: {epochs}
  per_device_train_batch_size: {EEG_BATCH}
  use_ibs_cls_loss: true
"""


class Rehearsal:
    """One rehearsal under ``args.root``: a method per step of STAGES,
    each returning its report entry but the wall time; ``run_step`` times
    one and writes the report."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.root = root = Path(args.root)
        root.mkdir(parents=True, exist_ok=True)
        self.report_path = root / "rehearsal_report.json"
        self.report = (json.loads(self.report_path.read_text())
                       if self.report_path.exists() else {})
        self.report.setdefault("config", vars(args))
        self.meta_path = root / "complete_metadata.json"
        self.eeg_dir = root / "eeg_npy"
        self.csv_dir = root / "eeg_csv"
        self.jpg_dir = root / "gaze_jpg"
        self.win_dir = root / "windows"
        self.feat_dir = root / "features"
        self.eeg_run = root / "eeg_run"
        self.gaze_run = root / "gaze_run"
        self.checkpoint = self.eeg_run / "checkpoints" / "best_model.pt"

    @property
    def meta(self) -> list:
        return json.loads(self.meta_path.read_text())

    def run_step(self, name: str) -> dict:
        print(f"[stage] {name}")
        k1 = phase_metrics.launch_count["phase_metric_sums"]
        t0 = time.time()
        try:
            out = getattr(self, name)()
        except ImportError as e:
            raise ImportError(f"stage {name} needs {e.name}, which is not installed here; run "
                              "it where it is, or leave it out of --stages") from e
        dt = time.time() - t0
        entry = {"wall_s": dt, **out, "peak_rss_gib": peak_rss_gib(),
                 "k1_launches": phase_metrics.launch_count["phase_metric_sums"] - k1}
        self.report[name] = entry
        self.report_path.write_text(json.dumps(self.report, indent=2))
        print(f"[stage] {name}: {dt:.1f}s, peak RSS {entry['peak_rss_gib']:.2f} GiB")
        return entry

    # -- gen ---------------------------------------------------------------
    def gen_metadata(self) -> dict:
        meta = build_metadata(self.args.trials)
        self.meta_path.write_text(json.dumps(meta))
        n_train = sum(1 for m in meta if m["pair"] in TRAIN_PAIRS)
        return {"trials": len(meta), "train_trials": n_train,
                "val_trials": len(meta) - n_train, "verify_ok": verify_metadata(meta)["ok"]}

    def gen_eeg_volume(self) -> dict:
        return {"trials": gen_eeg_volume(self.meta, self.eeg_dir),
                "bytes": (self.eeg_dir / "eeg1.npy").stat().st_size * 2}

    def gen_csv_subset(self) -> dict:
        return {"files": gen_csv_subset(self.meta, self.csv_dir, self.eeg_dir,
                                        self.args.csv_trials)}

    def gen_jpg_subset(self) -> dict:
        return {"files": gen_jpg_subset(self.meta, self.jpg_dir, self.args.jpg_trials),
                "resolution": f"{JPG_W}x{JPG_H}"}

    # -- convert -----------------------------------------------------------
    def convert_eeg_csv(self) -> dict:
        """The CSV subset through ``preprocess_eeg_raw``; its first trial
        must come back within 1e-3 of the volume's."""
        csv_meta = self.root / "csv_metadata.json"
        csv_meta.write_text(json.dumps(self.meta[:self.args.csv_trials]))
        out = self.root / "eeg_from_csv"
        call(preprocess_eeg_raw, ["--metadata", csv_meta, "--eeg-dir", self.csv_dir,
                                  "--output-dir", out])
        conv = np.load(out / "train_eeg1.npy", mmap_mode="r")
        orig = np.load(self.eeg_dir / "eeg1.npy", mmap_mode="r")
        err = float(np.abs(conv[0] - orig[0]).max())
        if not err < 1e-3:
            raise RuntimeError(f"CSV round-trip error {err}")
        return {"roundtrip_max_err": err}

    def convert_gaze_jpg(self) -> dict:
        jpg_meta = self.root / "jpg_metadata.json"
        jpg_meta.write_text(json.dumps(jpg_subset(self.meta, self.args.jpg_trials)))
        call(convert_gaze_images, ["--metadata", jpg_meta, "--image-root", self.jpg_dir,
                                   "--output", self.root / "gaze_converted",
                                   "--size", GAZE_SIZE])
        return {}

    # -- windows, features -------------------------------------------------
    def windows_full(self) -> dict:
        """Every trial through ``preprocess_eeg_windows``; the window counts
        must be the pair split's (28,683 / 11,484 at 4,463 trials)."""
        call(preprocess_eeg_windows, [
            "--input-dir", self.eeg_dir, "--output-dir", self.win_dir, "--sampling-rate", FS,
            "--window-size", WINDOW, "--stride", STRIDE, "--split-mode", "pair",
            "--device", self.args.device])
        tr = json.loads((self.win_dir / "train_metadata.json").read_text())
        va = json.loads((self.win_dir / "val_metadata.json").read_text())
        expected = list(expected_windows(self.meta)[2:])
        if self.args.trials == FULL_TRIALS and expected != list(FULL_WINDOWS):
            raise RuntimeError(f"the pair split of {FULL_TRIALS} trials gives {expected} "
                               f"windows, not {list(FULL_WINDOWS)}")
        if [tr["windows"], va["windows"]] != expected:
            raise RuntimeError(f"windows: {tr['windows']} / {va['windows']}, the pair split "
                               f"gives {expected}")
        return {"train_windows": tr["windows"], "val_windows": va["windows"],
                "expected": expected}

    def extract_features(self) -> dict:
        """The first ``--features-trials`` trials through
        ``extract_eeg_features``; ``sec_per_trial`` over the whole step,
        ``trials_per_s`` over the extractor alone (without the copy of its
        input)."""
        t_step = time.time()
        sub = self.feat_dir / "input"
        sub.mkdir(parents=True, exist_ok=True)
        n = self.args.features_trials
        for f in ("eeg1", "eeg2", "labels", "pairs"):
            np.save(sub / f"{f}.npy", np.load(self.eeg_dir / f"{f}.npy", mmap_mode="r")[:n])
        t0 = time.time()
        call(extract_eeg_features, ["--input-dir", sub, "--output-dir", self.feat_dir / "out",
                                    "--sampling-rate", FS, "--device", self.args.device])
        dt, step_s = time.time() - t0, time.time() - t_step
        return {"trials": n, "extract_s": dt, "trials_per_s": n / dt,
                "sec_per_trial": step_s / n,
                "full_4463_extrapolated_min": step_s / n * FULL_TRIALS / 60}

    # -- train -------------------------------------------------------------
    def train_eeg_full_windows(self) -> dict:
        """The flagship for ``--eeg-epochs`` over the windows at full width;
        it must write best_model.pt, with finite train losses."""
        # A previous run's best_metric.json would keep this run's checkpoint
        # from replacing best_model, and the analysis would read a stale model.
        shutil.rmtree(self.eeg_run, ignore_errors=True)
        cfg = self.root / "eeg_train_cfg.yaml"
        cfg.write_text(eeg_train_yaml(self.win_dir, self.eeg_run, self.args.eeg_epochs))
        result = call(train_dual_eeg, ["--config", cfg, "--device", self.args.device])
        require(self.checkpoint, "train_dual_eeg")
        losses = [h["train/loss"] for h in result["history"]]
        if not np.isfinite(losses).all():
            raise RuntimeError(f"train_dual_eeg: train losses {losses}")
        steps = result["trainer"].optimizer.count
        val = json.loads((self.win_dir / "val_metadata.json").read_text())["windows"]
        eval_bs = min(load_yaml_config(cfg).training.per_device_eval_batch_size, val)
        epoch_s = sum(h["train/epoch_time_s"] for h in result["history"])
        return {"train_steps": steps, "eval_batches": len(losses) * math.ceil(val / eval_bs),
                "steps_per_s": steps / epoch_s, "train_loss": losses,
                "best_metric": result["best_metric"]}

    def gaze_config(self) -> Path:
        """GAZE_CONFIG with its output_dir moved to ``<root>/gaze_run``."""
        import yaml

        raw = yaml.safe_load(Path(GAZE_CONFIG).read_text())
        raw["training"]["output_dir"] = str(self.gaze_run)
        path = self.root / "gaze_train_cfg.yaml"
        path.write_text(yaml.safe_dump(raw, sort_keys=False))
        return path

    def train_gaze_converted(self) -> dict:
        shutil.rmtree(self.gaze_run, ignore_errors=True)
        result = call(train_gaze, [
            "--config", self.gaze_config(), "--model", "early", "--epochs",
            self.args.gaze_epochs, "--batch-size", GAZE_BATCH, "--images",
            self.root / "gaze_converted", "--device", self.args.device, *GAZE_FLAGS])
        require(self.gaze_run / "checkpoints" / "best_model.pt", "train_gaze")
        steps = result["trainer"].optimizer.count
        epoch_s = sum(h["train/epoch_time_s"] for h in result["history"])
        return {"train_steps": steps, "steps_per_s": steps / epoch_s,
                "best_metric": result["best_metric"]}

    # -- analyze -----------------------------------------------------------
    def entropy_argv(self) -> list:
        return ["--gaze-dir", self.jpg_dir, "--eeg-dir", self.csv_dir, "--output-dir",
                self.root / "entropy_out", "--fs", FS, "--device", self.args.device]

    def analyze_entropy_real_files(self) -> dict:
        call(analyze_entropy, self.entropy_argv())
        return {}

    def analyze_eeg_argv(self) -> list:
        return ["--checkpoint", self.checkpoint, "--output-dir", self.root / "eeg_analysis",
                "--analyses", "metrics", "--device", self.args.device]

    def analyze_eeg_ckpt(self) -> dict:
        """``analyze_eeg --analyses metrics`` on the train step's checkpoint,
        which must be there; ``forwards`` is the analysis' planned forwards."""
        require(self.checkpoint, "the train stage (train_eeg_full_windows)")
        summary = call(analyze_eeg, self.analyze_eeg_argv(),
                       lambda argv: analyze_eeg.run(analyze_eeg.parse_args(argv)))
        return {"forwards": sum(summary["planned"].values())}


def select_steps(stages: str) -> list:
    """The steps ``--stages`` names (stage or step names), in STEPS' order."""
    names = set(stages.split(","))
    unknown = sorted(names - set(STAGES) - set(STEPS))
    if unknown:
        raise SystemExit(f"unknown stages {unknown}; choose from {', '.join(STAGES)} or the "
                         f"steps {', '.join(STEPS)}")
    return [s for g, steps in STAGES.items() for s in steps if g in names or s in names]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--root", default="runs/rehearsal")
    ap.add_argument("--trials", type=int, default=FULL_TRIALS)
    ap.add_argument("--csv-trials", type=int, default=100)
    ap.add_argument("--jpg-trials", type=int, default=112)
    ap.add_argument("--features-trials", type=int, default=64)
    ap.add_argument("--eeg-epochs", type=int, default=1)
    ap.add_argument("--gaze-epochs", type=int, default=1)
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="stage names (gen, convert, windows, features, train, analyze) or "
                         "step names, comma-separated")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the CUDA card; 'cpu' must be asked for)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device, "eyegaze_tpu_torch.rehearsal_full_scale")
    steps = select_steps(args.stages)
    rehearsal = Rehearsal(args)
    for step in steps:
        rehearsal.run_step(step)
    print(json.dumps(rehearsal.report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
