"""Train the gaze ViTs on gaze-heatmap pairs on one device or data-parallel
over several: early fusion, late fusion, or a bare ViT on data-level fused
pairs.

The counterpart of ``scripts/train_gaze.py``:

    python -m eyegaze_tpu_torch.train_gaze --config configs/gaze_earlyfusion.yaml
        [--model early|late|datafusion] [--data-fusion-mode horizontal]
        [--image-norm imagenet|vit] [--tiny] [--epochs N] [--batch-size N]
        [--images DIR | --image-root DIR --metadata FILE] [--pretrained FILE.npz]
        [--watch N] [--resume] [--device cpu] [--mesh [dp|dpN|tpN|dpN,tpM]]

The recipe is the JAX script's: validation held out by pair ID
(``data.val_pairs``), inverse-frequency weighted cross entropy when
``training.use_class_weights`` is set, a per-step linear warmup and cosine
decay of the LR, AdamW with clipping, bf16 compute when ``training.bf16``
is set, the best model by validation macro F1.  Inside each step, on the
device: ``to_unit_float``, the augment (train steps only: one flip and one
colour jitter drawn per pair, shared by both images, from a
``torch.Generator`` on the device) and the ImageNet normalization; for
``datafusion`` the pair is fused in image space and resized back to the
model's size first, then normalized by ``--image-norm``.

Images are the seeded synthetic heatmaps unless ``--images`` (arrays from
``python -m eyegaze_tpu_torch.convert_gaze_images``) or ``--image-root`` +
``--metadata`` (JPGs decoded directly, with PIL) is given.
``--pretrained`` copies a local timm-named ``.npz``
(``scripts/export_timm_weights.py``'s output) into the ViT.  ``--tiny``
shrinks the ViT to img 64, embed 64, depth 2, 4 heads.

It writes ``<output_dir>/checkpoints/best_model.pt`` (+ ``.meta.json``,
``.train.pt``) on every better validation F1 and ``checkpoint_epoch_<n>.*``
every ``save_every_n_epochs``.  The meta carries ``model.kind``,
``model.vit_num_heads`` and, for ``datafusion``, ``model.data_fusion_mode``
and ``model.image_norm``, so that ``GazePredictor.from_checkpoint`` and
``python -m eyegaze_tpu_torch.serve --kind gaze`` serve it back.
``--resume`` continues after the latest periodic checkpoint, from its epoch
and train step (the JAX script restarts at epoch 0).  Training runs on the
CUDA card unless ``--device cpu`` asks for the CPU; without a card it stops
with a message.  ``--mesh`` trains on a mesh, one rank per card (dp x tp
gloo ranks with ``--device cpu``; ``train_dual_eeg``'s docstring):
``training.per_device_train_batch_size`` is the global batch and must split
over the dp ranks, and dropout and the augment draw from ``seed +
dp_rank`` (the tp ranks of one data rank see the same images; dropout
inside the sharded regions draws from ``seed + rank``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.config import ExperimentConfig, load_yaml_config
from eyegaze_tpu_torch.data.gaze_augment import augment_gaze_pair
from eyegaze_tpu_torch.data.image_fusion import (
    DATA_FUSION_MODES,
    fuse_image_pair,
    imagenet_normalize,
    resize_bilinear,
    to_unit_float,
    vit_processor_normalize,
)
from eyegaze_tpu_torch.data.loader import ArrayDataset, batch_iterator
from eyegaze_tpu_torch.data.metadata import class_weights
from eyegaze_tpu_torch.data.synthetic import synthetic_gaze_pair_dataset
from eyegaze_tpu_torch.models.vit import (
    EarlyFusionViT,
    LateFusionViT,
    VisionTransformer,
    load_timm_state_dict,
)
from eyegaze_tpu_torch.parallel import gather_rows
from eyegaze_tpu_torch.train.losses import cross_entropy, weighted_cross_entropy
from eyegaze_tpu_torch.train.optim import make_optimizer, warmup_cosine_schedule
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
from eyegaze_tpu_torch.train_dual_eeg import resolve_device
from eyegaze_tpu_torch.utils.logging import RunLogger

KINDS = ("early", "late", "datafusion")
TINY = dict(embed_dim=64, depth=2, num_heads=4)  # at img 64
# Where each kind keeps its ViT: the early model's ``backbone``, the late
# model's shared ``encoder``, the datafusion model itself.
VIT_KEY = {"early": "backbone", "late": "encoder", "datafusion": ""}


def build_model(cfg: ExperimentConfig, kind: str, *, tiny: bool = False,
                device: torch.device) -> torch.nn.Module:
    """The ``kind`` model at ``cfg.model.img_size`` (``--tiny``: the small
    ViT), dropout ``training.dropout``, bf16 compute when ``training.bf16``,
    weights drawn from ``system.seed``."""
    kw = dict(num_classes=3, img_size=cfg.model.img_size, dropout=cfg.training.dropout,
              device=device, generator=torch.Generator().manual_seed(cfg.system.seed),
              dtype=torch.bfloat16 if cfg.training.bf16 else torch.float32,
              **(TINY if tiny else {}))
    if kind == "early":
        return EarlyFusionViT(fusion_mode=cfg.model.fusion_mode, **kw)
    if kind == "late":
        return LateFusionViT(fusion_mode=cfg.model.fusion_mode, **kw)
    if kind == "datafusion":
        return VisionTransformer(**kw)
    raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")


def prepare_data(cfg: ExperimentConfig, images=None, image_root=None,
                 metadata=None) -> tuple[ArrayDataset, ArrayDataset]:
    """(train, val) datasets of {'img1', 'img2', 'label'}, validation held
    out by pair ID.  Images are float32 in [0, 1] (the synthetic fixtures)
    or uint8 (converted arrays under ``images``, or JPGs under
    ``image_root`` listed in the ``metadata`` file)."""
    if images:
        from eyegaze_tpu_torch.data.images import load_converted_gaze

        data = load_converted_gaze(images).as_dataset().arrays
    elif image_root:
        from eyegaze_tpu_torch.data.images import load_gaze_pairs
        from eyegaze_tpu_torch.data.metadata import load_metadata

        data = load_gaze_pairs(load_metadata(metadata), image_root,
                               size=cfg.model.img_size).as_dataset().arrays
    else:
        d = cfg.data
        data = synthetic_gaze_pair_dataset(n=d.synthetic_trials, H=cfg.model.img_size,
                                           W=cfg.model.img_size, seed=d.random_seed)
    val = np.isin(data["pair"], np.asarray(cfg.data.val_pairs))

    def subset(mask):
        return ArrayDataset({k: data[k][mask] for k in ("img1", "img2", "label")})

    return subset(~val), subset(val)


def make_objective(kind: str, *, img_size: int, weights=None, generator: torch.Generator,
                   data_fusion_mode: str = "horizontal", image_norm: str = "imagenet"):
    """(loss_fn, eval_logits_fn) for the Trainer.  The loss is the (class-
    ``weights``-weighted) cross entropy on the augmented pair, the augment
    drawn from ``generator``; the eval forward takes the pair as it is.  The weighted mean divides by the batch's sum of weights,
    so under data parallelism it takes the global batch's logits and labels
    (``gather_rows``, an identity on one device)."""
    if kind == "datafusion":
        if data_fusion_mode not in DATA_FUSION_MODES:
            raise ValueError(f"data_fusion_mode must be one of {DATA_FUSION_MODES}")
        norm = {"imagenet": imagenet_normalize, "vit": vit_processor_normalize}[image_norm]

        def forward(model, img1, img2):
            fused = fuse_image_pair(img1, img2, data_fusion_mode)
            if fused.shape[-2:] != (img_size, img_size):  # the pastes change H or W
                fused = resize_bilinear(fused, img_size, img_size)
            return model(norm(fused))
    else:
        def forward(model, img1, img2):
            return model(imagenet_normalize(img1), imagenet_normalize(img2))

    def loss_fn(model, batch):
        img1, img2 = augment_gaze_pair(generator, to_unit_float(batch["img1"]),
                                       to_unit_float(batch["img2"]))
        logits = forward(model, img1, img2)
        labels = batch["label"]
        loss = (cross_entropy(logits, labels) if weights is None
                else weighted_cross_entropy(gather_rows(logits), gather_rows(labels), weights))
        return loss, {"logits": logits, "loss_ce": loss}

    def eval_logits_fn(model, batch):
        return forward(model, to_unit_float(batch["img1"]), to_unit_float(batch["img2"]))

    return loss_fn, eval_logits_fn


def run(cfg: ExperimentConfig, kind: str = "early", *, device: torch.device, tiny: bool = False,
        data_fusion_mode: str = "horizontal", image_norm: str = "imagenet", images=None,
        image_root=None, metadata=None, resume: bool = False, watch: int = 0) -> dict:
    """Train the ``kind`` model as ``cfg`` says on ``device``; returns the fit
    result ({best_metric, history}), the trainer and the validation split.
    ``--tiny`` sets ``cfg.model.img_size`` to 64.  With ``system.mesh`` and
    no running group it spawns the ranks, each running this function, and
    returns rank 0's fit result."""
    if cfg.system.mesh and not parallel.active():
        return parallel.fit_on_ranks(
            run, parallel.mesh_world(cfg.system.mesh, device), device, cfg, kind, tiny=tiny,
            data_fusion_mode=data_fusion_mode, image_norm=image_norm, images=images,
            image_root=image_root, metadata=metadata, resume=resume, watch=watch)
    if tiny:
        cfg.model.img_size = 64
    t = cfg.training
    model = build_model(cfg, kind, tiny=tiny, device=device)
    if cfg.model.pretrained and cfg.model.pretrained_path:
        vit = model.get_submodule(VIT_KEY[kind])
        load_timm_state_dict(vit, dict(np.load(cfg.model.pretrained_path)))
        print(f"[model] loaded pretrained weights from {cfg.model.pretrained_path}")
    train_ds, val_ds = prepare_data(cfg, images, image_root, metadata)
    print(f"[data] train: {len(train_ds)}, val: {len(val_ds)}")
    print(f"[model] {kind}-fusion ViT ({cfg.model.fusion_mode}): "
          f"{sum(p.numel() for p in model.parameters()):,} params on {device}")
    bs = min(t.per_device_train_batch_size, len(train_ds))
    if cfg.system.mesh:
        parallel.require_divisible(bs, parallel.join_mesh(cfg.system.mesh)[0])
    rank = parallel.data_rank_and_world()[0]  # the augment's: one draw per data rank
    steps_per_epoch = max(len(train_ds) // bs, 1)
    schedule = warmup_cosine_schedule(t.learning_rate,
                                      int(steps_per_epoch * max(t.warmup_epochs, 0)),
                                      steps_per_epoch * t.num_train_epochs)
    optimizer = make_optimizer(model, schedule, t.weight_decay, grad_clip=t.grad_clip)
    weights = (torch.as_tensor(class_weights(train_ds.arrays["label"].tolist()), device=device)
               if t.use_class_weights else None)
    generator = torch.Generator(device=device)
    loss_fn, eval_logits_fn = make_objective(
        kind, img_size=cfg.model.img_size, weights=weights, generator=generator,
        data_fusion_mode=data_fusion_mode, image_norm=image_norm)
    logger = RunLogger(t.output_dir, cfg.wandb.run_name, use_wandb=cfg.wandb.enabled)
    trainer = Trainer(
        model, optimizer, loss_fn, eval_logits_fn,
        TrainerConfig(num_epochs=t.num_train_epochs, save_every_epochs=t.save_every_n_epochs,
                      metric_for_best="f1_macro",
                      checkpoint_dir=str(Path(t.output_dir) / "checkpoints"),
                      seed=cfg.system.seed, use_mesh=cfg.system.mesh,
                      watch_every_epochs=watch),
        device=device, logger=logger.log, watch_logger=logger.log_watch if watch else None,
    )
    start_epoch = 0
    if resume:
        latest = trainer.ckpt.latest_epoch()
        if latest is not None:
            step = trainer.restore(f"checkpoint_epoch_{latest}")
            start_epoch = latest + 1
            print(f"[resume] restored epoch {latest}, step {step}")
    # A resumed run draws other augments than the epochs it continues did.
    generator.manual_seed(cfg.system.seed + rank + 100003 * start_epoch)

    # The meta lets serving rebuild the model: the kind, the head count (no
    # parameter shape holds it) and the datafusion preprocessing.
    config_dict = cfg.to_dict()
    vit = model.get_submodule(VIT_KEY[kind])
    config_dict["model"].update(kind=kind, vit_num_heads=vit.blocks[0].attn.num_heads)
    if kind == "datafusion":
        config_dict["model"].update(data_fusion_mode=data_fusion_mode, image_norm=image_norm)
    eval_bs = min(t.per_device_eval_batch_size, max(len(val_ds), 1))
    result = trainer.fit(
        train_batches_fn=lambda epoch: batch_iterator(train_ds, bs, shuffle=True,
                                                      seed=cfg.system.seed,
                                                      drop_remainder=True, epoch=epoch),
        eval_batches_fn=lambda: batch_iterator(val_ds, eval_bs),
        config_dict=config_dict,
        start_epoch=start_epoch,
    )
    if trainer.rank == 0:  # the ranks but 0 keep no best metric
        print(f"[done] best f1_macro: {result['best_metric']}")
    return {**result, "trainer": trainer, "val": val_ds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--model", choices=KINDS, default="early")
    ap.add_argument("--data-fusion-mode", default="horizontal", choices=DATA_FUSION_MODES,
                    help="data-level fusion op for --model datafusion")
    ap.add_argument("--image-norm", choices=["imagenet", "vit"], default="imagenet",
                    help="datafusion normalization: 'imagenet' (default) or 'vit' (the HF "
                         "ViTImageProcessor's 0.5 / 0.5, to [-1, 1])")
    ap.add_argument("--resume", action="store_true",
                    help="continue after the latest periodic checkpoint")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--tiny", action="store_true", help="img 64, embed 64, depth 2, 4 heads")
    ap.add_argument("--images", default=None,
                    help="converted gaze-array dir (python -m "
                         "eyegaze_tpu_torch.convert_gaze_images)")
    ap.add_argument("--image-root", default=None, help="raw JPG directory (decoded directly)")
    ap.add_argument("--metadata", default=None,
                    help="complete_metadata.json (required with --image-root)")
    ap.add_argument("--pretrained", default=None,
                    help=".npz of timm ViT weights (scripts/export_timm_weights.py); "
                         "overrides the config's pretrained_path")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="log param/grad histograms every N epochs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: system.device, the CUDA card; 'cpu' must be "
                         "asked for)")
    ap.add_argument("--mesh", nargs="?", const="dp", default=None,
                    help="device-mesh spec (system.mesh): 'dp' = data-parallel "
                         "over all local devices; 'dpN,tpM' / 'tpM' adds a "
                         "tensor-parallel model axis (Megatron-style weight "
                         "sharding, parallel/sharding.py)")
    args = ap.parse_args(argv)
    if args.image_root and not args.metadata:
        ap.error("--image-root requires --metadata")

    cfg = load_yaml_config(args.config)
    if args.mesh:
        cfg.system.mesh = args.mesh
    if args.epochs is not None:
        cfg.training.num_train_epochs = args.epochs
    if args.batch_size is not None:
        cfg.training.per_device_train_batch_size = args.batch_size
    if args.pretrained:
        cfg.model.pretrained, cfg.model.pretrained_path = True, args.pretrained
    device = resolve_device(args.device or cfg.system.device, "eyegaze_tpu_torch.train_gaze")
    return run(cfg, args.model, device=device, tiny=args.tiny,
               data_fusion_mode=args.data_fusion_mode, image_norm=args.image_norm,
               images=args.images, image_root=args.image_root, metadata=args.metadata,
               resume=args.resume, watch=args.watch)


if __name__ == "__main__":
    main()
