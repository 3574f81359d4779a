"""Train the multimodal fuzzy-gating composite (gaze + EEG) on one device or
data-parallel over several.

The counterpart of ``scripts/train_multimodal.py``:

    python -m eyegaze_tpu_torch.train_multimodal --config configs/multimodal_fuzzy_fusion.yaml
        [--epochs N] [--tiny] [--resume] [--watch N] [--gaze-checkpoint DIR]
        [--eeg-checkpoint DIR] [--images DIR --eeg DIR] [--device cpu] [--mesh [dp|dpN|tpN|dpN,tpM]]

The recipe is the JAX script's:

- the model: ``MultimodalFusionModel`` from the YAML (``eeg_max_len =
  max(window_size // 4, 256)``, bf16 compute when ``training.bf16`` is set)
  or, with ``--tiny``, the JAX script's small constructor (img 64, ViT
  64 / 1 layer / 4 heads, EEG 64 / 1 layer / 4 heads / d_ff 128,
  ``eeg_max_len`` 512);
- the data: one sample per EEG window with its trial's two images
  (``MultimodalArrays``).  Without ``--images`` / ``--eeg`` the seeded
  synthetic gaze and EEG fixtures, one window per trial (stride =
  window), the last ``max(n // 5, 1)`` trials for validation; with them,
  the converted gaze arrays joined to each EEG split by its
  ``{split}_metadata.json``'s ``metadata_indices``;
- inside each step, on the device, the images made unit-float and
  ImageNet-normalized;
- the loss ``CE(fused) + lambda_img CE(img_logits / T_img) + lambda_eeg
  CE(eeg_logits / T_eeg) + lambda_temp temp_reg``, the temperatures taken
  detached from ``aux_info``;
- AdamW (clip ``training.grad_clip``) with two constant learning rates:
  ``encoder_learning_rate`` (else a tenth of ``learning_rate``) for
  ``gaze_encoder.*`` and ``eeg_encoder.*``, ``learning_rate`` for the gate.
  ``freeze_encoders`` freezes the encoders; an explicit
  ``encoder_learning_rate`` of 0.0 holds them by a zero rate.  The YAML's
  ``scheduler`` is not read, as the JAX script does not read it;
- the best model by validation macro F1.

``--gaze-checkpoint`` and ``--eeg-checkpoint`` name the checkpoint
directory of a port ``train_gaze --model early`` or ``train_dual_eeg`` run;
its ``best_model.pt`` goes into the encoder (``load_pretrained_encoder``).

It writes ``<output_dir>/checkpoints/best_model.pt`` (+ ``.meta.json``,
``.train.pt``) on every better validation F1 and ``checkpoint_epoch_<n>.*``
every ``save_every_n_epochs``.  The meta's ``model.multimodal`` holds the
constructor's fields, so ``MultimodalPredictor.from_checkpoint`` and
``python -m eyegaze_tpu_torch.serve --kind multimodal`` rebuild the model.
``--resume`` continues after the latest periodic checkpoint, from its epoch
and train step (the JAX script restarts at epoch 0).  Training runs on the
CUDA card unless ``--device cpu`` asks for the CPU; without a card it stops
with a message.  ``--mesh`` trains on a mesh, one rank per card (dp x tp
gloo ranks with ``--device cpu``; ``train_dual_eeg``'s docstring):
``training.per_device_train_batch_size`` is the global batch and must split
over the dp ranks, and dropout draws from ``seed + dp_rank`` (``seed +
rank`` inside the sharded regions).  On the card the EEG
encoder launches the phase-metrics kernel K1 once per train step and once
per eval batch, on every rank.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.config import ExperimentConfig, load_yaml_config
from eyegaze_tpu_torch.data.image_fusion import imagenet_normalize, to_unit_float
from eyegaze_tpu_torch.data.loader import MultimodalArrays
from eyegaze_tpu_torch.data.synthetic import (
    synthetic_eeg_pair_dataset,
    synthetic_gaze_pair_dataset,
)
from eyegaze_tpu_torch.models.multimodal import FIELDS, MultimodalFusionModel
from eyegaze_tpu_torch.train.losses import cross_entropy
from eyegaze_tpu_torch.train.optim import Optimizer, make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
from eyegaze_tpu_torch.train_dual_eeg import resolve_device
from eyegaze_tpu_torch.utils.logging import RunLogger

# scripts/train_multimodal.py:93-101, at img 64.
TINY = dict(img_size=64, vit_embed_dim=64, vit_depth=1, vit_num_heads=4, eeg_d_model=64,
            eeg_num_layers=1, eeg_num_heads=4, eeg_d_ff=128, eeg_max_len=512)
ENCODERS = ("gaze_encoder", "eeg_encoder")


def build_model(cfg: ExperimentConfig, *, tiny: bool = False,
                device: torch.device) -> MultimodalFusionModel:
    """The composite as the JAX script builds it (``--tiny``: its small
    constructor), dropout ``training.dropout``, bf16 compute when
    ``training.bf16``, weights drawn from ``system.seed``."""
    m = cfg.model
    kw = dict(gaze_fusion_mode=m.fusion_mode, fuzzy_mode=m.fuzzy_mode,
              eeg_in_channels=m.in_channels, use_spectrogram=cfg.ablation.use_spectrogram,
              dropout=cfg.training.dropout, device=device,
              generator=torch.Generator().manual_seed(cfg.system.seed),
              dtype=torch.bfloat16 if cfg.training.bf16 else torch.float32)
    if tiny:
        return MultimodalFusionModel(**TINY, **kw)
    return MultimodalFusionModel(
        img_size=m.img_size, eeg_d_model=m.d_model, eeg_num_layers=m.num_layers,
        eeg_num_heads=m.num_heads, eeg_d_ff=m.d_ff,
        eeg_max_len=max(cfg.data.window_size // 4, 256), sampling_rate=cfg.data.sampling_rate,
        use_cross_attention=cfg.ablation.use_cross_attention, **kw)


def prepare_data(cfg: ExperimentConfig, images=None,
                 eeg=None) -> tuple[MultimodalArrays, MultimodalArrays]:
    """(train, val): the converted gaze arrays under ``images`` joined to
    the EEG splits under ``eeg``, else the seeded synthetic fixtures at
    ``model.img_size`` with the last fifth of the trials for validation."""
    d = cfg.data
    if images:
        from eyegaze_tpu_torch.data.images import load_converted_gaze

        def build(split):
            eeg_dir = Path(eeg)
            meta = json.loads((eeg_dir / f"{split}_metadata.json").read_text())
            gaze = load_converted_gaze(images,
                                       indices=np.asarray(meta["metadata_indices"], np.int64))
            return MultimodalArrays(
                img1=gaze.img1, img2=gaze.img2,
                eeg1=np.load(eeg_dir / f"{split}_eeg1.npy"),
                eeg2=np.load(eeg_dir / f"{split}_eeg2.npy"),
                labels=np.load(eeg_dir / f"{split}_labels.npy"),
                pairs=np.load(eeg_dir / f"{split}_pairs.npy"),
                window_size=d.window_size, stride=d.stride)

        return build("train"), build("val")
    n = d.synthetic_trials
    gaze = synthetic_gaze_pair_dataset(n=n, H=cfg.model.img_size, W=cfg.model.img_size,
                                       seed=d.random_seed)
    pairs = synthetic_eeg_pair_dataset(n=n, C=cfg.model.in_channels, T=d.window_size,
                                       fs=d.sampling_rate, seed=d.random_seed)
    n_val = max(n // 5, 1)

    def build(sl):
        return MultimodalArrays(img1=gaze["img1"][sl], img2=gaze["img2"][sl],
                                eeg1=pairs["eeg1"][sl], eeg2=pairs["eeg2"][sl],
                                labels=pairs["label"][sl], window_size=d.window_size,
                                stride=d.window_size)

    return build(slice(None, -n_val)), build(slice(-n_val, None))


def make_objective(cfg: ExperimentConfig):
    """(loss_fn, eval_logits_fn) for the Trainer: the JAX script's loss
    (``:198-224``) and eval forward, the images prepared on the device."""
    t = cfg.training

    def forward(model, batch):
        img1, img2 = (imagenet_normalize(to_unit_float(batch[k])) for k in ("img1", "img2"))
        return model(img1, img2, batch["eeg1"], batch["eeg2"])

    def loss_fn(model, batch):
        out = forward(model, batch)
        labels = batch["label"]
        loss_fused = cross_entropy(out["logits"], labels)
        temps = out["aux_info"]["temperatures"]  # detached: no gradient reaches T here
        loss_img = cross_entropy(out["img_logits"] / temps["img"], labels)
        loss_eeg = cross_entropy(out["eeg_logits"] / temps["eeg"], labels)
        loss = (loss_fused + t.lambda_img * loss_img + t.lambda_eeg * loss_eeg
                + t.lambda_temp_reg * out["temp_reg"])
        return loss, {"logits": out["logits"], "loss_fused": loss_fused, "loss_img": loss_img,
                      "loss_eeg": loss_eeg, "loss_alpha_mean": out["alpha"].mean()}

    def eval_logits_fn(model, batch):
        return forward(model, batch)["logits"]

    return loss_fn, eval_logits_fn


def make_multimodal_optimizer(model: MultimodalFusionModel, cfg: ExperimentConfig) -> Optimizer:
    """AdamW with the "encoder" group (``gaze_encoder.*``, ``eeg_encoder.*``)
    at ``encoder_learning_rate`` (a tenth of ``learning_rate`` when it is
    None; 0.0 is a zero rate) and the "fusion" group at ``learning_rate``;
    ``freeze_encoders`` freezes the "encoder" group."""
    t = cfg.training
    encoder_lr = (t.encoder_learning_rate if t.encoder_learning_rate is not None
                  else t.learning_rate * 0.1)

    def group_of(name, _param):
        return "encoder" if name.split(".")[0] in ENCODERS else "fusion"

    return make_optimizer(model, t.learning_rate, t.weight_decay, grad_clip=t.grad_clip,
                          param_groups=group_of,
                          group_lrs={"encoder": encoder_lr, "fusion": t.learning_rate},
                          frozen_groups=("encoder",) if t.freeze_encoders else ())


def load_pretrained_encoder(model: MultimodalFusionModel, path, scope: str) -> tuple[int, int]:
    """Copies a port checkpoint's state_dict (``best_model.pt`` of
    ``train_gaze --model early`` for ``scope`` "gaze_encoder", of
    ``train_dual_eeg`` for "eeg_encoder") into the encoder ``scope``: each
    name of the encoder's state_dict that the checkpoint holds with the same
    shape is copied, the rest keep their values (the JAX script's
    intersection, ``:39-57``).  The names map with the scope as a prefix:
    the early ViT's ``backbone.*`` is the composite's
    ``gaze_encoder.backbone.*``, the flagship's ``encoder.layers.0.*`` its
    ``eeg_encoder.encoder.layers.0.*``.  Prints and returns (matched,
    total)."""
    src = torch.load(path, map_location="cpu", weights_only=True)
    dst = model.get_submodule(scope).state_dict()
    matched = [k for k, v in dst.items() if k in src and src[k].shape == v.shape]
    with torch.no_grad():
        for k in matched:
            dst[k].copy_(src[k])
    print(f"[pretrained] {scope}: matched {len(matched)}/{len(dst)} params")
    return len(matched), len(dst)


def run(cfg: ExperimentConfig, *, device: torch.device, tiny: bool = False, images=None,
        eeg=None, gaze_checkpoint=None, eeg_checkpoint=None, resume: bool = False,
        watch: int = 0) -> dict:
    """Train the composite as ``cfg`` says on ``device``; returns the fit
    result ({best_metric, history}), the trainer and the validation split.
    ``tiny`` sets ``cfg.model.img_size`` to 64.  With ``system.mesh`` and no
    running group it spawns the ranks, each running this function, and
    returns rank 0's fit result."""
    if cfg.system.mesh and not parallel.active():
        return parallel.fit_on_ranks(
            run, parallel.mesh_world(cfg.system.mesh, device), device, cfg, tiny=tiny,
            images=images, eeg=eeg, gaze_checkpoint=gaze_checkpoint,
            eeg_checkpoint=eeg_checkpoint, resume=resume, watch=watch)
    if bool(images) != bool(eeg):
        raise ValueError("images and eeg must be given together")
    if tiny:
        cfg.model.img_size = 64
    t = cfg.training
    model = build_model(cfg, tiny=tiny, device=device)
    train_ds, val_ds = prepare_data(cfg, images, eeg)
    print(f"[data] train: {len(train_ds)} windows, val: {len(val_ds)} windows")
    print(f"[model] multimodal composite ({cfg.model.fuzzy_mode} gate): "
          f"{sum(p.numel() for p in model.parameters()):,} params on {device}")
    for scope, ckpt in (("gaze_encoder", gaze_checkpoint), ("eeg_encoder", eeg_checkpoint)):
        if ckpt:
            load_pretrained_encoder(model, Path(ckpt) / "best_model.pt", scope)
    loss_fn, eval_logits_fn = make_objective(cfg)
    logger = RunLogger(t.output_dir, cfg.wandb.run_name, use_wandb=cfg.wandb.enabled)
    trainer = Trainer(
        model, make_multimodal_optimizer(model, cfg), loss_fn, eval_logits_fn,
        TrainerConfig(num_epochs=t.num_train_epochs, save_every_epochs=t.save_every_n_epochs,
                      metric_for_best="f1_macro",
                      checkpoint_dir=str(Path(t.output_dir) / "checkpoints"),
                      seed=cfg.system.seed, use_mesh=cfg.system.mesh,
                      # The EEG encoder's IBS head feeds no loss.
                      find_unused_parameters=model.use_ibs, watch_every_epochs=watch),
        device=device, logger=logger.log, watch_logger=logger.log_watch if watch else None,
    )
    start_epoch = 0
    if resume:
        latest = trainer.ckpt.latest_epoch()
        if latest is not None:
            step = trainer.restore(f"checkpoint_epoch_{latest}")
            start_epoch = latest + 1
            print(f"[resume] restored epoch {latest}, step {step}")

    # The constructor's fields, which no parameter shape fully holds (the
    # head counts), for MultimodalPredictor.from_checkpoint.
    config_dict = cfg.to_dict()
    config_dict["model"]["multimodal"] = {f: getattr(model, f) for f in FIELDS}
    bs = min(t.per_device_train_batch_size, len(train_ds))
    if cfg.system.mesh:
        parallel.require_divisible(bs, parallel.data_rank_and_world()[1])
    result = trainer.fit(
        train_batches_fn=lambda epoch: train_ds.iter_batches(
            bs, shuffle=True, seed=cfg.system.seed, drop_remainder=True, epoch=epoch),
        eval_batches_fn=lambda: val_ds.iter_batches(min(bs, len(val_ds))),
        config_dict=config_dict,
        start_epoch=start_epoch,
    )
    if trainer.rank == 0:  # the ranks but 0 keep no best metric
        print(f"[done] best f1_macro: {result['best_metric']}")
    return {**result, "trainer": trainer, "val": val_ds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="img 64, ViT 64/1/4, EEG 64/1/4/128, eeg_max_len 512")
    ap.add_argument("--resume", action="store_true",
                    help="continue after the latest periodic checkpoint")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="log param/grad histograms every N epochs")
    ap.add_argument("--gaze-checkpoint", default=None,
                    help="checkpoint dir of a train_gaze --model early run (its best_model.pt)")
    ap.add_argument("--eeg-checkpoint", default=None,
                    help="checkpoint dir of a train_dual_eeg run (its best_model.pt)")
    ap.add_argument("--images", default=None,
                    help="converted gaze-array dir (python -m "
                         "eyegaze_tpu_torch.convert_gaze_images)")
    ap.add_argument("--eeg", default=None,
                    help="converted EEG trial dir ({split}_eeg1/eeg2/labels/pairs.npy and "
                         "{split}_metadata.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: system.device, the CUDA card; 'cpu' must be "
                         "asked for)")
    ap.add_argument("--mesh", nargs="?", const="dp", default=None,
                    help="device-mesh spec (system.mesh): 'dp' = data-parallel "
                         "over all local devices; 'dpN,tpM' / 'tpM' adds a "
                         "tensor-parallel model axis (Megatron-style weight "
                         "sharding, parallel/sharding.py)")
    args = ap.parse_args(argv)
    if bool(args.images) != bool(args.eeg):
        ap.error("--images and --eeg must be given together")

    cfg = load_yaml_config(args.config)
    if args.mesh:
        cfg.system.mesh = args.mesh
    if args.epochs is not None:
        cfg.training.num_train_epochs = args.epochs
    device = resolve_device(args.device or cfg.system.device,
                            "eyegaze_tpu_torch.train_multimodal")
    return run(cfg, device=device, tiny=args.tiny, images=args.images, eeg=args.eeg,
               gaze_checkpoint=args.gaze_checkpoint, eeg_checkpoint=args.eeg_checkpoint,
               resume=args.resume, watch=args.watch)


if __name__ == "__main__":
    main()
