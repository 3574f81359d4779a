"""Train HyperEEG, with its six documented ablations, on one device or
data-parallel over several.

The counterpart of ``scripts/train_hypereeg.py``, with its flags and
defaults:

    python -m eyegaze_tpu_torch.train_hypereeg [--ablation full|baseline|no_sinc|no_graph|
        no_cross|no_uncertainty] [--preset documented|680k] [--epochs 150]
        [--batch-size 256] [--lr 5e-4] [--warmup-epochs 10] [--window 1024]
        [--stride 256] [--channels 32] [--fs 250] [--trials 48] [--no-augment]
        [--tiny] [--output-dir DIR] [--watch N] [--device cpu]
        [--mesh [dp|dpN|tpN|dpN,tpM]]

The recipe is the JAX script's: the model in float32 (the JAX script passes
no ``dtype``), weights from seed 42 (``--tiny``: embed 32, 4 heads, sinc
kernel 33); the seeded synthetic pairs at T = max(window, 1024), windowed
at ``--window`` / ``--stride``, pairs 33-40 held out for validation; AdamW
(weight decay 0.01, clip 1.0) under a per-step linear warmup and cosine
decay; in training, ``augment_eeg`` (time masking, channel dropout,
Gaussian noise, drawn from a ``torch.Generator`` on the device) on each
stream before the forward, then cross entropy; the best model by
validation macro F1.

It writes ``<output-dir>/checkpoints/best_model.pt`` (+ ``.meta.json``,
``.train.pt``), default ``runs/eeg_hypereeg/<ablation>``; the meta's
``model.hypereeg`` holds the constructor's fields, so
``HyperEEGPredictor.from_checkpoint`` and ``python -m
eyegaze_tpu_torch.serve --kind hypereeg`` rebuild the model.  There is no
``--resume``, as in the JAX script.  Training runs on the CUDA card unless
``--device cpu`` asks for the CPU; without a card it stops with a message.
``--mesh`` trains on a mesh, one rank per card (dp x tp gloo ranks with
``--device cpu``; ``train_dual_eeg``'s docstring): ``--batch-size`` is the
global batch and must split over the dp ranks, and dropout and the augment
draw from ``seed + dp_rank`` (``seed + rank`` inside the sharded regions).  HyperEEG's attentions are Flax's and
launch no kernel of the port.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.data.augment import augment_eeg
from eyegaze_tpu_torch.data.loader import DualEEGWindowDataset
from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset
from eyegaze_tpu_torch.models.hypereeg import (
    ABLATIONS,
    FIELDS,
    PRESETS,
    HyperEEGEncoder,
    create_hypereeg_model,
)
from eyegaze_tpu_torch.train.losses import cross_entropy
from eyegaze_tpu_torch.train.optim import make_optimizer, warmup_cosine_schedule
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
from eyegaze_tpu_torch.train_dual_eeg import resolve_device
from eyegaze_tpu_torch.utils.logging import RunLogger

SEED = 42
VAL_PAIRS = np.arange(33, 41)
TINY = dict(embed_dim=32, num_heads=4, sinc_kernel_size=33)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--ablation", choices=list(ABLATIONS), default="full")
    ap.add_argument("--preset", choices=list(PRESETS), default="documented",
                    help="width preset: 'documented' (embed 128, the default) or '680k' "
                         "(embed 208, 671,459 parameters)")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--warmup-epochs", type=int, default=10)
    ap.add_argument("--window", type=int, default=1024)
    ap.add_argument("--stride", type=int, default=256)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--fs", type=float, default=250.0)
    ap.add_argument("--trials", type=int, default=48)
    ap.add_argument("--augment", action="store_true", default=True)
    ap.add_argument("--no-augment", dest="augment", action="store_false")
    ap.add_argument("--tiny", action="store_true", help="embed 32, 4 heads, sinc kernel 33")
    ap.add_argument("--output-dir", default=None,
                    help="default runs/eeg_hypereeg/<ablation>")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="log param/grad histograms every N epochs")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the CUDA card; 'cpu' must be asked for)")
    ap.add_argument("--mesh", nargs="?", const="dp", default=None,
                    help="device-mesh spec (system.mesh): 'dp' = data-parallel "
                         "over all local devices; 'dpN,tpM' / 'tpM' adds a "
                         "tensor-parallel model axis (Megatron-style weight "
                         "sharding, parallel/sharding.py)")
    return ap.parse_args(argv)


def build_model(args: argparse.Namespace, *, device: torch.device,
                dropout: float = 0.1) -> HyperEEGEncoder:
    """The float32 model of ``--ablation`` at ``--preset`` (``--tiny``: the
    small widths), weights from seed 42."""
    kw = dict(in_channels=args.channels, sample_rate=args.fs, dropout=dropout, device=device,
              generator=torch.Generator().manual_seed(SEED))
    if args.tiny:
        return create_hypereeg_model(args.ablation, **TINY, **kw)
    return create_hypereeg_model(args.ablation, preset=args.preset, **kw)


def prepare_data(args: argparse.Namespace) -> tuple[DualEEGWindowDataset, DualEEGWindowDataset]:
    """(train, val) windowed datasets of the seeded synthetic pairs,
    validation the pairs 33-40."""
    data = synthetic_eeg_pair_dataset(n=args.trials, C=args.channels, T=max(args.window, 1024),
                                      fs=args.fs, seed=SEED)
    val = np.isin(data["pair"], VAL_PAIRS)

    def subset(mask):
        return DualEEGWindowDataset(data["eeg1"][mask], data["eeg2"][mask], data["label"][mask],
                                    window_size=args.window, stride=args.stride,
                                    pairs=data["pair"][mask])

    return subset(~val), subset(val)


def make_objective(*, augment: bool, generator: torch.Generator):
    """(loss_fn, eval_logits_fn) for the Trainer: cross entropy on the
    logits, each stream through ``augment_eeg`` (drawn from ``generator``)
    first when ``augment``; the eval forward takes the windows as they are."""

    def loss_fn(model, batch):
        e1, e2 = batch["eeg1"], batch["eeg2"]
        if augment:
            e1, e2 = augment_eeg(generator, e1), augment_eeg(generator, e2)
        logits = model(e1, e2)["logits"]
        loss = cross_entropy(logits, batch["label"])
        return loss, {"logits": logits, "loss_ce": loss}

    def eval_logits_fn(model, batch):
        return model(batch["eeg1"], batch["eeg2"])["logits"]

    return loss_fn, eval_logits_fn


def run(args: argparse.Namespace, *, device: torch.device) -> dict:
    """Train as ``args`` (``parse_args``'s) say on ``device``; returns the
    fit result ({best_metric, history}), the trainer and the validation
    split.  With ``args.mesh`` and no running group it spawns the ranks,
    each running this function, and returns rank 0's fit result."""
    if args.mesh and not parallel.active():
        return parallel.fit_on_ranks(run, parallel.mesh_world(args.mesh, device), device, args)
    out_dir = args.output_dir or f"runs/eeg_hypereeg/{args.ablation}"
    model = build_model(args, device=device)
    train_ds, val_ds = prepare_data(args)
    print(f"[data] train windows: {len(train_ds)}, val windows: {len(val_ds)}")
    print(f"[model] HyperEEG[{args.ablation}]: "
          f"{sum(p.numel() for p in model.parameters()):,} params on {device}")
    bs = min(args.batch_size, len(train_ds))
    if args.mesh:
        parallel.require_divisible(bs, parallel.join_mesh(args.mesh)[0])
    rank = parallel.data_rank_and_world()[0]  # the augment's: one draw per data rank
    steps_per_epoch = max(len(train_ds) // bs, 1)
    schedule = warmup_cosine_schedule(args.lr, args.warmup_epochs * steps_per_epoch,
                                      args.epochs * steps_per_epoch)
    generator = torch.Generator(device=device).manual_seed(SEED + rank)
    logger = RunLogger(out_dir, f"hypereeg_{args.ablation}")
    trainer = Trainer(
        model, make_optimizer(model, schedule, 0.01, grad_clip=1.0),
        *make_objective(augment=args.augment, generator=generator),
        TrainerConfig(num_epochs=args.epochs, metric_for_best="f1_macro",
                      checkpoint_dir=str(Path(out_dir) / "checkpoints"), seed=SEED,
                      use_mesh=args.mesh, watch_every_epochs=args.watch),
        device=device, logger=logger.log, watch_logger=logger.log_watch if args.watch else None,
    )
    eval_bs = min(bs, max(len(val_ds), 1))
    result = trainer.fit(
        train_batches_fn=lambda epoch: train_ds.iter_batches(
            bs, shuffle=True, seed=SEED, drop_remainder=True, epoch=epoch),
        eval_batches_fn=(lambda: val_ds.iter_batches(eval_bs)) if len(val_ds) else None,
        config_dict={"ablation": args.ablation,
                     "model": {"hypereeg": {f: getattr(model, f) for f in FIELDS}}},
    )
    if trainer.rank == 0:  # the ranks but 0 keep no best metric
        print(f"[done] best f1_macro: {result['best_metric']}")
    return {**result, "trainer": trainer, "val": val_ds}


def main(argv=None):
    args = parse_args(argv)
    return run(args, device=resolve_device(args.device, "eyegaze_tpu_torch.train_hypereeg"))


if __name__ == "__main__":
    main()
