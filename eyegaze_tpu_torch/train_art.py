"""Train the Artifact Removal Transformer (EEG denoising seq2seq) on one device
or data-parallel over several.

The counterpart of ``scripts/train_art.py``:

    python -m eyegaze_tpu_torch.train_art [--epochs 5] [--trials 64] [--loss-zscore]
        [--attn-dropout 0.0] [--tiny] [--output-dir runs/art_torch] [--device cpu]
        [--mesh [dp|dpN|tpN|dpN,tpM]]

Noisy -> clean pairs from the seeded generators (clean multi-sine EEG; the
input is it plus Gaussian noise of std 0.5), the last fifth held out for
validation, the decoder teacher-forced on the clean target, MSE or
z-scored MSE (``art_loss``), AdamW with weight decay 0.01, clip 1.0 and a
per-epoch cosine schedule, dropout on.  Evaluation reports the loss and the
SNR of the input and of the reconstruction against the clean signal; the
best validation loss writes ``<output_dir>/checkpoints/best_model.pt`` (+
``.meta.json`` holding the ``ArtConfig``), which
``ArtDenoiser.from_checkpoint`` serves.

``--attn-dropout 0.0`` turns off dropout on the softmax weights only (a
recipe the JAX package documents): then every T = 1024 attention call of a
train step runs the attention kernel K3 forward and its autograd backward
on the card.  By default attention dropout follows the model's dropout and
train steps take the plain attention path; evaluation runs K3 either way.
Training runs on the CUDA card unless ``--device cpu`` asks for the CPU;
without a card it stops with a message.  ``--mesh`` trains on a mesh,
one rank per card (dp x tp gloo ranks with ``--device cpu``;
``train_dual_eeg``'s docstring): ``--batch-size`` is the global batch and
must split over the dp ranks, dropout draws from ``seed + dp_rank`` (and
``seed + rank`` inside the sharded regions), and the evaluation's SNR is
the global batch's (``Trainer``).  At ``--attn-dropout 0.0`` every rank
runs K3 and its backward on its own rows and, under tp, on its H / tp
heads.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.data.loader import ArrayDataset, batch_iterator
from eyegaze_tpu_torch.data.synthetic import gen_eeg
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer, art_loss
from eyegaze_tpu_torch.train.optim import cosine_annealing_schedule, make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
from eyegaze_tpu_torch.train_dual_eeg import resolve_device
from eyegaze_tpu_torch.utils.logging import RunLogger


def build_dataset(n: int, C: int, T: int, seed: int = 42) -> ArrayDataset:
    """Noisy -> clean pairs: clean = multi-sine EEG, input = clean + noise
    of std 0.5, the JAX script's seeds."""
    clean = np.stack([gen_eeg(C, T, mode="sine", seed=seed * 100019 + i) for i in range(n)])
    noise = np.stack([gen_eeg(C, T, mode="noise", noise_std=0.5, seed=seed * 100003 + i)
                      for i in range(n)])
    return ArrayDataset({"input_values": clean + noise, "labels": clean})


def build_config(args: argparse.Namespace) -> ArtConfig:
    """Full width (``ArtConfig``'s defaults) or the ``--tiny`` geometry."""
    if args.tiny:
        return ArtConfig(in_channels=args.channels, out_channels=args.channels,
                         embedding_size=32, num_encoder_layers=1, num_decoder_layers=1,
                         num_heads=4, feedforward_size=64, max_len=args.length,
                         attn_dropout=args.attn_dropout)
    return ArtConfig(in_channels=args.channels, out_channels=args.channels,
                     max_len=max(args.length, 2048), loss_zscore=args.loss_zscore,
                     attn_dropout=args.attn_dropout)


def make_objective(loss_zscore: bool):
    """(loss_fn, eval_metrics_fn) for the Trainer: the teacher-forced loss,
    and the loss with the SNR in dB of the input and of the reconstruction
    against the clean target."""

    def loss_fn(model, batch):
        recon = model(batch["input_values"], batch["labels"])
        return art_loss(recon, batch["labels"], loss_zscore=loss_zscore), {}

    def eval_metrics_fn(model, batch):
        x, y = batch["input_values"], batch["labels"]
        recon = model(x, y)
        sig = torch.sum(y ** 2)

        def snr_db(est):
            return 10.0 * torch.log10(sig / (torch.sum((est - y) ** 2) + 1e-12))

        snr_in, snr_out = snr_db(x), snr_db(recon)
        return {"loss": art_loss(recon, y, loss_zscore=loss_zscore), "snr_in_db": snr_in,
                "snr_out_db": snr_out, "snr_improvement_db": snr_out - snr_in}

    return loss_fn, eval_metrics_fn


def run(args: argparse.Namespace, *, device: torch.device) -> dict:
    """Train as ``args`` say on ``device``; returns the fit result
    ({best_metric, history}), the trainer and the validation split.  With
    ``args.mesh`` and no running group it spawns the ranks, each running
    this function, and returns rank 0's fit result."""
    if args.mesh and not parallel.active():
        return parallel.fit_on_ranks(run, parallel.mesh_world(args.mesh, device), device, args)
    cfg = build_config(args)
    model = ArtifactRemovalTransformer(cfg, device=device,
                                       generator=torch.Generator().manual_seed(42))
    ds = build_dataset(args.trials, args.channels, args.length)
    n_val = max(args.trials // 5, 1)
    train_ds = ArrayDataset({k: v[:-n_val] for k, v in ds.arrays.items()})
    val_ds = ArrayDataset({k: v[-n_val:] for k, v in ds.arrays.items()})
    print(f"[model] ART: {sum(p.numel() for p in model.parameters()):,} params on {device}")

    bs = min(args.batch_size, len(train_ds))
    if args.mesh:
        parallel.require_divisible(bs, parallel.join_mesh(args.mesh)[0])
    steps_per_epoch = max(len(train_ds) // bs, 1)
    optimizer = make_optimizer(model, cosine_annealing_schedule(args.lr, args.epochs,
                                                                steps_per_epoch),
                               0.01, grad_clip=1.0)
    loss_fn, eval_metrics_fn = make_objective(args.loss_zscore)
    logger = RunLogger(args.output_dir, "art")
    trainer = Trainer(
        model, optimizer, loss_fn, None,
        TrainerConfig(num_epochs=args.epochs, metric_for_best="loss", greater_is_better=False,
                      checkpoint_dir=str(Path(args.output_dir) / "checkpoints"), seed=7,
                      use_mesh=args.mesh, watch_every_epochs=args.watch),
        device=device, logger=logger.log, eval_metrics_fn=eval_metrics_fn,
        watch_logger=logger.log_watch if args.watch else None,
    )
    result = trainer.fit(
        train_batches_fn=lambda epoch: batch_iterator(train_ds, bs, shuffle=True, seed=42,
                                                      drop_remainder=True, epoch=epoch),
        eval_batches_fn=lambda: batch_iterator(val_ds, min(bs, len(val_ds))),
        # The ArtConfig in the meta: ArtDenoiser.from_checkpoint rebuilds the model from it.
        config_dict={"model": dataclasses.asdict(cfg)},
    )
    if trainer.rank == 0:  # the ranks but 0 keep no best metric
        print(f"[done] best val loss: {result['best_metric']}")
    return {**result, "trainer": trainer, "val": val_ds}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--length", type=int, default=1024)
    ap.add_argument("--loss-zscore", action="store_true")
    ap.add_argument("--attn-dropout", type=float, default=None,
                    help="attention-weight dropout (default: follows the model dropout); 0.0 "
                         "disables only the softmax-weight dropout")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--output-dir", default="runs/art_torch")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="log param/grad histograms every N epochs")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' must be asked for)")
    ap.add_argument("--mesh", nargs="?", const="dp", default=None,
                    help="device-mesh spec (system.mesh): 'dp' = data-parallel "
                         "over all local devices; 'dpN,tpM' / 'tpM' adds a "
                         "tensor-parallel model axis (Megatron-style weight "
                         "sharding, parallel/sharding.py)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device, "eyegaze_tpu_torch.train_art")
    return run(args, device=device)["best_metric"]


if __name__ == "__main__":
    main()
