"""Train the DualEEGTransformer on one device or data-parallel over several.

The counterpart of ``scripts/train_dual_eeg.py``:

    python -m eyegaze_tpu_torch.train_dual_eeg --config configs/dual_eeg_transformer.yaml
        [--resume] [--watch N] [--epochs N] [--batch-size N] [--synthetic-trials N]
        [--device cpu] [--mesh [dp|dpN|tpN|dpN,tpM]] [--multihost]

The config schema is the reference YAML's.  Data come from the real
pre-split or unsplit ``.npy`` layout under ``data.eeg_base_path`` when it is
there, else from the seeded synthetic fixtures, split by the same seeded
stratified split as the JAX package.  Training runs on the CUDA card
(``system.device``; the YAML's accelerator names "tpu" and "gpu" mean it),
and on the CPU only when ``--device cpu`` or ``system.device: cpu`` asks
for it; without a card it stops with a message.  It writes
``<output_dir>/checkpoints/best_model.pt`` (+ ``.meta.json``, ``.train.pt``)
on every better validation metric and ``checkpoint_epoch_<n>.*`` every
``save_every_n_epochs``: ``Predictor.from_checkpoint`` serves the ``.pt``,
and ``scripts/import_torch_checkpoint.py`` imports it into the JAX package.
``--resume`` continues after the latest periodic checkpoint, from its epoch
and train step.

``--mesh`` (or ``system.mesh``) trains over the local devices: the entry
point spawns one rank per card ("dp": every visible card; "dpN": N of
them; "tpN" and "dpN,tpM" add a tensor-parallel model axis, Megatron
column and row layers, ``parallel/tensor.py``; a spec that needs more
cards than there are raises), or dp x tp gloo ranks with ``--device cpu``.
``training.per_device_train_batch_size`` stays the global batch, as in the
JAX script, and must split evenly over the dp ranks;
the IBS alignment and contrastive losses take the rows of the global batch
(``parallel.gather_rows``), so a step equals one device's.  ``--multihost``
joins the group that torchrun started (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): each process loads its
``process_shard_bounds`` slice of the split and trains its own batches of
``per_device_train_batch_size`` rows, as many an epoch as the smallest
shard holds; without torchrun's variables it trains in one process, as
``--mesh dp1`` does.  There the world is the spec's dp x tp ("dp" when no
spec is given): the tp ranks of one data rank load the same slice.
"""

from __future__ import annotations

import argparse
import itertools
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.config import ExperimentConfig, load_yaml_config
from eyegaze_tpu_torch.data.loader import DualEEGWindowDataset
from eyegaze_tpu_torch.data.metadata import stratified_split
from eyegaze_tpu_torch.data.synthetic import synthetic_eeg_pair_dataset
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.ops.preprocess import common_average_reference, zscore
from eyegaze_tpu_torch.ops.spectral import bandpass_fft
from eyegaze_tpu_torch.parallel import gather_rows
from eyegaze_tpu_torch.train.losses import (
    cross_entropy,
    ibs_alignment_loss,
    ibs_contrastive_loss,
    symmetry_loss,
)
from eyegaze_tpu_torch.train.optim import cosine_annealing_schedule, make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
from eyegaze_tpu_torch.utils.logging import RunLogger

# The JAX bench's train-step objective (bench.py:223-258) as training.*
# toggles and weights: CE + 0.1 sym + 0.1 align + 0.3 IBS-CE + 0.1 contrastive.
BENCH_LOSSES = dict(use_sym_loss=True, use_ibs_loss=True, use_ibs_cls_loss=True,
                    use_ibs_contrastive=True, lambda_sym=0.1, lambda_ibs=0.1,
                    lambda_ibs_cls=0.3, lambda_ibs_contrastive=0.1)


def resolve_device(name: str, program: str = "eyegaze_tpu_torch.train_dual_eeg") -> torch.device:
    """``name`` as a torch device: "tpu" and "gpu", the reference YAML's
    accelerators, mean the CUDA card.  A CUDA device must exist, or
    ``program`` stops with a message."""
    device = torch.device("cuda" if name in ("tpu", "gpu") else name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{program} needs a CUDA device; pass --device cpu to run on the CPU")
    return device


def build_model(cfg: ExperimentConfig, *, device: torch.device,
                dtype: torch.dtype = torch.float32) -> DualEEGTransformer:
    """The configured model, its weights drawn from ``system.seed``."""
    abl = cfg.ablation
    return DualEEGTransformer(
        in_channels=cfg.model.in_channels,
        num_classes=cfg.model.num_labels,
        d_model=cfg.model.d_model,
        num_layers=cfg.model.num_layers,
        num_heads=cfg.model.num_heads,
        d_ff=cfg.model.d_ff,
        dropout=cfg.training.dropout,
        max_len=max(cfg.data.window_size // 4, 256),
        conv_kernel_size=cfg.model.conv_kernel_size,
        conv_stride=cfg.model.conv_stride,
        conv_layers=cfg.model.conv_layers,
        sampling_rate=cfg.data.sampling_rate,
        use_spectrogram=abl.use_spectrogram,
        spec_n_fft=cfg.model.spec_n_fft,
        spec_hop_length=cfg.model.spec_hop_length,
        spec_freq_bins=cfg.model.spec_freq_bins,
        use_robust_ibs=(abl.ibs_mode == "robust"),
        use_ibs=abl.use_ibs,
        use_cross_attention=abl.use_cross_attention,
        ibs_instance_norm=abl.ibs_instance_norm,
        ibs_feature_type=abl.ibs_feature_type,
        device=device,
        generator=torch.Generator().manual_seed(cfg.system.seed),
        dtype=dtype,
    )


def prepare_datasets(cfg: ExperimentConfig, process_shard: bool = False):
    """Trial-level arrays -> windowed (train, val) datasets (stratified
    split seeded from ``data.random_seed``, train_art.py:69-139 semantics).

    Real data: ``data.eeg_base_path`` holding the output of
    scripts/preprocess_eeg_raw.py ({train,val}_eeg{1,2}/labels/pairs.npy, or
    unsplit eeg1/eeg2/labels/pairs.npy, split here).  Otherwise the seeded
    synthetic fixtures.  ``process_shard`` (``--multihost``): every process
    computes the same split (or reads the pre-split files) and keeps its
    contiguous ``process_shard_bounds`` slice of each side's trials, trimmed
    to a multiple of the processes first; the identity with one process.
    The JAX script shards only the split it computes: each of its processes
    loads the whole of a pre-split layout.
    """
    d = cfg.data
    eeg_dir = Path(d.eeg_base_path) if d.eeg_base_path else None

    def windowed(e1, e2, labels, pairs):
        return DualEEGWindowDataset(e1, e2, labels, window_size=d.window_size,
                                    stride=d.stride, pairs=pairs)

    world = parallel.data_rank_and_world()[1]

    def my_slice(ids):
        ids = list(ids)[:len(ids) - len(ids) % world]
        lo, hi = parallel.process_shard_bounds(len(ids))
        return ids[lo:hi]

    if eeg_dir and (eeg_dir / "train_eeg1.npy").exists():
        def load(split):
            mmap = "r" if process_shard else None  # a process reads its slice alone
            arrays = [np.load(eeg_dir / f"{split}_{name}.npy", mmap_mode=mmap)
                      for name in ("eeg1", "eeg2", "labels")]
            pairs = eeg_dir / f"{split}_pairs.npy"
            arrays.append(np.load(pairs, mmap_mode=mmap) if pairs.exists() else None)
            ids = my_slice(range(len(arrays[2]))) if process_shard else slice(None)
            return windowed(*(None if a is None else np.asarray(a[ids]) for a in arrays))
        print(f"[data] real pre-split npy from {eeg_dir}")
        return load("train"), load("val")

    if eeg_dir and (eeg_dir / "eeg1.npy").exists():
        print(f"[data] real unsplit npy from {eeg_dir}")
        data = {
            "eeg1": np.load(eeg_dir / "eeg1.npy"),
            "eeg2": np.load(eeg_dir / "eeg2.npy"),
            "label": np.load(eeg_dir / "labels.npy"),
            "pair": np.load(eeg_dir / "pairs.npy"),
        }
    else:
        data = synthetic_eeg_pair_dataset(
            n=d.synthetic_trials, C=cfg.model.in_channels,
            T=max(d.window_size, 1024), fs=d.sampling_rate, seed=d.random_seed,
        )
    idx = list(range(len(data["label"])))
    train_idx, val_idx = stratified_split(
        idx, data["label"], test_size=d.train_test_split, seed=d.random_seed
    )
    if process_shard:
        train_idx, val_idx = my_slice(train_idx), my_slice(val_idx)

    def subset(ids):
        ids = np.asarray(ids)
        return windowed(data["eeg1"][ids], data["eeg2"][ids], data["label"][ids],
                        data["pair"][ids])

    return subset(train_idx), subset(val_idx)


def make_objective(cfg: ExperimentConfig):
    """(loss_fn, eval_logits_fn) for the Trainer: the configured loss terms
    (``training.use_*`` and ``lambda_*``) and the eval forward, each behind
    the optional bandpass + CAR + z-score of ``data.enable_preprocessing``.
    The IBS alignment and contrastive terms couple the rows of the batch:
    under data parallelism they take the global batch's tokens and labels
    (``gather_rows``, an identity on one device); the other terms are rank
    means, which DDP's average makes the global mean."""
    t = cfg.training
    lam = dict(sym=t.lambda_sym, ibs=t.lambda_ibs, ibs_cls=t.lambda_ibs_cls,
               contrastive=t.lambda_ibs_contrastive)
    use = dict(sym=t.use_sym_loss, ibs=t.use_ibs_loss, ibs_cls=t.use_ibs_cls_loss,
               contrastive=t.use_ibs_contrastive)
    has_ibs = cfg.ablation.use_ibs

    def maybe_preprocess(x):
        """The SimpleEEGPreprocessor role of dual_eeg_dataset.py."""
        if not cfg.data.enable_preprocessing:
            return x
        x = bandpass_fft(x, cfg.data.filter_low, cfg.data.filter_high, cfg.data.sampling_rate)
        return zscore(common_average_reference(x))

    def loss_fn(model, batch):
        out = model(maybe_preprocess(batch["eeg1"]), maybe_preprocess(batch["eeg2"]))
        labels = batch["label"]
        loss = cross_entropy(out["logits"], labels)
        aux = {"logits": out["logits"], "loss_ce": loss}
        if use["sym"]:
            term = symmetry_loss(out["cls1"], out["cls2"])
            loss = loss + lam["sym"] * term
            aux["loss_sym"] = term
        if has_ibs and use["ibs"]:
            term = ibs_alignment_loss(gather_rows(out["ibs_token"]), gather_rows(out["cls1"]),
                                      gather_rows(out["cls2"]))
            loss = loss + lam["ibs"] * term
            aux["loss_ibs_align"] = term
        if has_ibs and use["ibs_cls"]:
            term = cross_entropy(out["ibs_logits"], labels)
            loss = loss + lam["ibs_cls"] * term
            aux["loss_ibs_cls"] = term
        if has_ibs and use["contrastive"]:
            term = ibs_contrastive_loss(gather_rows(out["ibs_token"]), gather_rows(labels))
            loss = loss + lam["contrastive"] * term
            aux["loss_contrastive"] = term
        return loss, aux

    def eval_logits_fn(model, batch):
        return model(maybe_preprocess(batch["eeg1"]), maybe_preprocess(batch["eeg2"]))["logits"]

    return loss_fn, eval_logits_fn


def run(cfg: ExperimentConfig, *, device: torch.device, resume: bool = False,
        watch: int = 0, multihost: bool = False) -> dict:
    """Train ``cfg`` on ``device``: returns the fit result ({best_metric,
    history}) and the trainer.  With ``system.mesh`` and no running group,
    it spawns the mesh's ranks, each running this function, and returns
    rank 0's fit result; ``multihost``: this process is a rank of torchrun's
    group, with its own shard of the data."""
    mesh = cfg.system.mesh
    if mesh and not parallel.active():
        return parallel.fit_on_ranks(run, parallel.mesh_world(mesh, device), device, cfg,
                                     resume=resume, watch=watch)
    if mesh:
        parallel.join_mesh(mesh)  # the data axis of the shards below
    t = cfg.training
    model = build_model(cfg, device=device, dtype=torch.bfloat16 if t.bf16 else torch.float32)
    train_ds, val_ds = prepare_datasets(cfg, process_shard=multihost)
    print(f"[data] train windows: {len(train_ds)}, val windows: {len(val_ds)}")
    bs = min(t.per_device_train_batch_size, len(train_ds))
    if mesh and not multihost:
        parallel.require_divisible(bs, parallel.data_rank_and_world()[1])
    steps_per_epoch = max(len(train_ds) // bs, 1)
    if multihost:
        # A trial's windows differ in number, so the shards may too: every
        # process takes the smallest shard's steps (DDP needs each step on
        # every rank, and the schedules must agree).
        own, steps_per_epoch = steps_per_epoch, parallel.common_steps(steps_per_epoch, bs)
        if own != steps_per_epoch:
            print(f"[multihost] {steps_per_epoch} train steps an epoch on every process, "
                  f"{own - steps_per_epoch} of this process's batches left out")
    print(f"[model] {sum(p.numel() for p in model.parameters()):,} parameters on {device}")

    schedule = cosine_annealing_schedule(t.learning_rate, t.num_train_epochs, steps_per_epoch)
    optimizer = make_optimizer(model, schedule, t.weight_decay, grad_clip=t.grad_clip)
    loss_fn, eval_logits_fn = make_objective(cfg)
    logger = RunLogger(t.output_dir, cfg.wandb.run_name, use_wandb=cfg.wandb.enabled)
    metric_map = {"f1": "f1_macro", "accuracy": "accuracy"}
    trainer = Trainer(
        model, optimizer, loss_fn, eval_logits_fn,
        TrainerConfig(
            num_epochs=t.num_train_epochs,
            save_every_epochs=t.save_every_n_epochs,
            metric_for_best=metric_map.get(t.metric_for_best_model, t.metric_for_best_model),
            greater_is_better=t.greater_is_better,
            checkpoint_dir=str(Path(t.output_dir) / "checkpoints"),
            seed=cfg.system.seed,
            use_mesh=mesh,
            local_batches=multihost,
            # The IBS logits without the IBS cross entropy: the IBS head
            # gets no gradient.
            find_unused_parameters=cfg.ablation.use_ibs and not t.use_ibs_cls_loss,
            watch_every_epochs=watch,
        ),
        device=device,
        num_classes=cfg.model.num_labels,
        logger=logger.log,
        watch_logger=logger.log_watch if watch else None,
    )
    start_epoch = 0
    if resume:
        latest = trainer.ckpt.latest_epoch()
        if latest is not None:
            step = trainer.restore(f"checkpoint_epoch_{latest}")
            start_epoch = latest + 1
            print(f"[resume] restored epoch {latest}, step {step}")

    eval_bs = min(t.per_device_eval_batch_size, max(len(val_ds), 1))
    result = trainer.fit(
        train_batches_fn=lambda epoch: itertools.islice(train_ds.iter_batches(
            bs, shuffle=True, seed=cfg.system.seed, drop_remainder=True, epoch=epoch),
            steps_per_epoch),
        eval_batches_fn=lambda: val_ds.iter_batches(eval_bs),
        config_dict=cfg.to_dict(),
        start_epoch=start_epoch,
    )
    if trainer.rank == 0:  # the ranks but 0 keep no best metric
        print(f"[done] best {t.metric_for_best_model}: {result['best_metric']}")
    return {**result, "trainer": trainer}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--resume", action="store_true",
                    help="continue after the latest periodic checkpoint")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="log param/grad histograms every N epochs "
                         "(wandb.watch role, train_gaze_earlyfusion.py:458)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--synthetic-trials", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: system.device, the CUDA card; 'cpu' must be "
                         "asked for)")
    ap.add_argument("--mesh", nargs="?", const="dp", default=None,
                    help="device-mesh spec (system.mesh): 'dp' = data-parallel "
                         "over all local devices; 'dpN,tpM' / 'tpM' adds a "
                         "tensor-parallel model axis (Megatron-style weight "
                         "sharding, parallel/sharding.py)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the group torchrun started, each process training its shard "
                         "of the data; without torchrun's variables, one process")
    args = ap.parse_args(argv)

    cfg = load_yaml_config(args.config)
    if args.mesh:
        cfg.system.mesh = args.mesh
    if args.epochs is not None:
        cfg.training.num_train_epochs = args.epochs
    if args.batch_size is not None:
        cfg.training.per_device_train_batch_size = args.batch_size
        cfg.training.per_device_eval_batch_size = args.batch_size
    if args.synthetic_trials is not None:
        cfg.data.synthetic_trials = args.synthetic_trials
    device = resolve_device(args.device or cfg.system.device)
    if not args.multihost:
        return run(cfg, device=device, resume=args.resume, watch=args.watch)
    rank, world = parallel.initialize_multihost(device)
    print(f"[multihost] process {rank}/{world}")
    if not parallel.active():
        cfg.system.mesh = False
        return run(cfg, device=device, resume=args.resume, watch=args.watch)
    if cfg.system.mesh:
        dp, tp = parallel.parse_mesh_spec(cfg.system.mesh, world)
        if dp * tp != world:
            raise SystemExit(f"--mesh {cfg.system.mesh}: under --multihost the group is "
                             f"torchrun's {world} processes, the spec's dp x tp")
    cfg.system.mesh = cfg.system.mesh or "dp"
    try:
        return run(cfg, device=parallel.local_device(device), resume=args.resume,
                   watch=args.watch, multihost=True)
    finally:
        parallel.leave()


if __name__ == "__main__":
    main()
