"""Rank functions of the tensor-parallelism tests (tests/test_torch_tensor_parallel*.py).

``eyegaze_tpu_torch.parallel.launch`` pickles a rank function by its module
and name, so the ranks import this module, which imports torch and the port
only: a rank starts without jax.  Each ``*_checks`` function runs every
check of one test module at one world size, in one launch, and returns what
the test process compares; the same functions run the one-process
references with ``mesh`` None.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from eyegaze_tpu_torch import parallel, serving, train_art, train_dual_eeg
from eyegaze_tpu_torch.config import config_from_dict
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.models.hypereeg import HyperEEGEncoder
from eyegaze_tpu_torch.models.multimodal import MultimodalFusionModel
from eyegaze_tpu_torch.models.transformer import Dense
from eyegaze_tpu_torch.models.vit import Attention, EarlyFusionViT
from eyegaze_tpu_torch.parallel import tensor
from eyegaze_tpu_torch.train.optim import make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

# The flagship at tests/test_torch_parallel.py's geometry, cross-brain
# attention on; ART and the ViT at small widths with 4 heads (2 a rank).
C, T = 8, 256
FLAGSHIP = {"model": {"in_channels": C, "d_model": 32, "num_layers": 1, "num_heads": 4,
                      "d_ff": 64},
            "ablation": {"use_spectrogram": False, "use_ibs": True, "ibs_mode": "robust",
                         "use_cross_attention": True},
            "data": {"window_size": T, "stride": 384, "sampling_rate": 256.0},
            "training": {"dropout": 0.0, "bf16": False, **train_dual_eeg.BENCH_LOSSES},
            "system": {"seed": 42}}
ART_C, ART_T = 4, 64
ART = dict(in_channels=ART_C, out_channels=ART_C, embedding_size=32, num_encoder_layers=1,
           num_decoder_layers=1, num_heads=4, feedforward_size=64, max_len=ART_T)
IMG = 32
VIT = dict(num_classes=3, img_size=IMG, fusion_mode="concat", embed_dim=32, depth=2, num_heads=4)
FAMILIES = ("flagship", "vit", "art")


def build(family: str, state: dict | None, device, dropout: float = 0.0) -> torch.nn.Module:
    """A family's tiny model at ``dropout``, ``state`` (numpy arrays by
    name) loaded where given.  At dropout 0 every dropout is off, the
    flagship's fixed 0.3 on its IBS head too."""
    g = torch.Generator().manual_seed(3)
    if family == "flagship":
        cfg = {**FLAGSHIP, "training": {**FLAGSHIP["training"], "dropout": dropout}}
        model = train_dual_eeg.build_model(config_from_dict(cfg), device=device)
    elif family == "vit":
        model = EarlyFusionViT(**VIT, dropout=dropout, device=device, generator=g)
    else:
        model = ArtifactRemovalTransformer(ArtConfig(**ART, dropout=dropout), device=device,
                                           generator=g)
    if state is not None:
        model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    if dropout == 0.0:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return model


def loss_fn(family: str):
    if family == "flagship":
        return train_dual_eeg.make_objective(config_from_dict(FLAGSHIP))[0]
    if family == "vit":
        return lambda m, b: (F.cross_entropy(m(b["img1"], b["img2"]), b["label"].long()), {})
    return train_art.make_objective(False)[0]


def full_grads(model: torch.nn.Module) -> dict:
    """Every parameter's gradient by name, the shards gathered over tp."""
    return {k: (tensor.gather_shard(p.grad, p.tp_shard) if tensor.is_sharded(p) else p.grad)
            .numpy().copy() for k, p in model.named_parameters()}


def full_params(model: torch.nn.Module) -> dict:
    return {k: v.numpy().copy() for k, v in tensor.full_state_dict(model).items()}


def step(family: str, state: dict, batch: dict, mesh, device) -> dict:
    """One Trainer step (learning rate 0, no clip) on the global ``batch``:
    the loss, the gradient norm, the gathered gradients, the layers'
    all_reduces and each rank's parameter count."""
    model = build(family, state, device)
    optimizer = make_optimizer(model, 0.0, weight_decay=0.0, grad_clip=None)
    trainer = Trainer(model, optimizer, loss_fn(family), None,
                      TrainerConfig(use_mesh=mesh, prefetch=0), device=device)
    tensor.all_reduce_count = 0
    stats = trainer.train_epoch([batch], 0)
    return {"loss": stats["train/loss"], "grad_norm": stats["train/grad_norm"],
            "grads": full_grads(model), "all_reduces": tensor.all_reduce_count,
            "numel": sum(p.numel() for p in model.parameters())}


def dropout_run(family: str, state: dict, batches: list, mesh, device) -> dict:
    """Three Trainer steps at dropout 0.1: the rank's replicated parameters
    and its shards."""
    model = build(family, state, device, dropout=0.1)
    trainer = Trainer(model, make_optimizer(model, 1e-3), loss_fn(family), None,
                      TrainerConfig(use_mesh=mesh, prefetch=0, seed=5), device=device)
    trainer.train_epoch(batches, 0)
    return {"replicated": {k: p.detach().numpy().copy() for k, p in model.named_parameters()
                           if not tensor.is_sharded(p)},
            "sharded": sorted(k for k, p in model.named_parameters() if tensor.is_sharded(p))}


def checkpoint_run(state: dict, batches: list, mesh, device, out_dir: str) -> dict:
    """ART trained two epochs with a periodic checkpoint a epoch, then
    resumed from epoch 0's checkpoint for the second: the full parameters
    after each."""
    def trainer():
        model = build("art", state, device)
        return Trainer(model, make_optimizer(model, 1e-3), loss_fn("art"), None,
                       TrainerConfig(num_epochs=2, save_every_epochs=1, checkpoint_dir=out_dir,
                                     use_mesh=mesh, prefetch=0), device=device)

    first = trainer()
    first.fit(lambda epoch: batches)
    resumed = trainer()
    resumed.restore("checkpoint_epoch_0")
    resumed.fit(lambda epoch: batches, start_epoch=1)
    return {"trained": full_params(first.model), "resumed": full_params(resumed.model),
            "steps": resumed.optimizer.count}


def resume_one_process_checkpoint(state: dict, batches: list, mesh, device,
                                  ckpt_dir: str) -> dict:
    """A one-process checkpoint resumed under ``mesh`` for one epoch: the
    full parameters after it."""
    model = build("art", state, device)
    trainer = Trainer(model, make_optimizer(model, 1e-3), loss_fn("art"), None,
                      TrainerConfig(num_epochs=2, checkpoint_dir=ckpt_dir, use_mesh=mesh,
                                    prefetch=0), device=device)
    trainer.restore("checkpoint_epoch_0")
    trainer.train_epoch(batches, 1)
    return full_params(trainer.model)


def train_checks(rank: int, world: int, device, payload: dict) -> dict:
    """Every check of tests/test_torch_tensor_parallel_train.py on this
    rank under ``payload["mesh"]``."""
    mesh = payload["mesh"]
    out = {"steps": {f: step(f, payload["states"][f], payload["batches"][f], mesh, device)
                     for f in FAMILIES},
           "data": parallel.data_rank_and_world(), "tp": parallel.tp_rank_and_world()}
    if payload.get("dropout"):
        out["dropout"] = {f: dropout_run(f, payload["states"][f], payload["dropout_batches"][f],
                                         mesh, device) for f in FAMILIES}
    if payload.get("ckpt_dir"):
        out["checkpoint"] = checkpoint_run(payload["states"]["art"], payload["art_epoch"], mesh,
                                           device, payload["ckpt_dir"])
        out["resumed_one_process"] = resume_one_process_checkpoint(
            payload["states"]["art"], payload["art_epoch"], mesh, device,
            payload["one_process_ckpt_dir"])
    return out


def _dense_pair(seed: int) -> tuple:
    g = torch.Generator().manual_seed(seed)
    first = Dense(8, 12, device=torch.device("cpu"))
    second = Dense(12, 8, device=torch.device("cpu"))
    for d in (first, second):
        with torch.no_grad():
            d.weight.copy_(torch.randn(d.weight.shape, generator=g))
            d.bias.copy_(torch.randn(d.bias.shape, generator=g))
    return first, second


def pair_forward(first, second, x, region: bool):
    if region:
        x = tensor.copy_to_region(x)
    return second(torch.relu(first(x)))


def layer_checks(rank: int, world: int, device, payload: dict) -> dict:
    """tests/test_torch_tensor_parallel.py's checks on two ranks: a column
    and a row layer cut from a pair of ``Dense`` against the pair, their
    gradients included, and the ViT attention's fused ``qkv`` split."""
    parallel.join_mesh("tp2")
    tp_rank, tp = parallel.tp_rank_and_world()
    first, second = _dense_pair(0)
    col = tensor._convert(first, tensor.ColumnParallelDense, parallel.Shard(0, 1), tp_rank, tp)
    row = tensor._convert(second, tensor.RowParallelDense, parallel.Shard(1, 1), tp_rank, tp)
    x = torch.tensor(payload["x"], requires_grad=True)
    tensor.all_reduce_count = 0
    y = pair_forward(col, row, x, region=True)
    (y * torch.tensor(payload["w"])).sum().backward()
    out = {"y": y.detach().numpy(), "dx": x.grad.numpy(), "count": tensor.all_reduce_count,
           "dw1": tensor.gather_shard(col.weight.grad, col.weight.tp_shard).numpy(),
           "db1": tensor.gather_shard(col.bias.grad, col.bias.tp_shard).numpy(),
           "dw2": tensor.gather_shard(row.weight.grad, row.weight.tp_shard).numpy(),
           "db2": row.bias.grad.numpy(), "w1_rows": col.weight.detach().numpy()}
    attn = Attention(32, 4, device=torch.device("cpu"))
    attn.load_state_dict({k: torch.tensor(v) for k, v in payload["attn"].items()})
    holder = torch.nn.Module()  # the ViT rule matches a module named attn
    holder.attn = attn
    plan = tensor.shard_tp_(holder, tp_rank, tp)
    out["attn_plan"] = sorted(plan)
    out["qkv_weight"] = attn.qkv.weight.detach().numpy().copy()
    out["qkv_bias"] = attn.qkv.bias.detach().numpy().copy()
    out["proj_weight"] = attn.proj.weight.detach().numpy().copy()
    out["heads"] = attn.num_heads
    with torch.no_grad():
        out["attn_out"] = attn(torch.tensor(payload["tokens"])).numpy()
    return out


# -- serving ---------------------------------------------------------------

EEG_MODEL = {"in_channels": C, "num_labels": 3, "d_model": 32, "num_layers": 1, "num_heads": 4,
             "d_ff": 64, "conv_kernel_size": 7}
GAZE = dict(num_classes=3, img_size=IMG, fusion_mode="concat", embed_dim=32, depth=1,
            num_heads=4)
MULTIMODAL = dict(num_classes=3, gaze_fusion_mode="concat", fuzzy_mode="full", eeg_in_channels=C,
                  eeg_d_model=32, eeg_num_layers=1, eeg_num_heads=4, eeg_d_ff=64,
                  eeg_max_len=128, use_spectrogram=False, vit_embed_dim=32, vit_depth=1,
                  vit_num_heads=4, img_size=IMG)
HYPEREEG = dict(in_channels=C, embed_dim=32, num_heads=4, sinc_kernel_size=15)
KINDS = ("eeg", "gaze", "art", "multimodal", "hypereeg")


def served_model(kind: str, dtype=torch.float32) -> torch.nn.Module:
    """A kind's tiny model, weights from seed 0 (``write_checkpoints``)."""
    kw = dict(device=torch.device("cpu"), generator=torch.Generator().manual_seed(0), dtype=dtype)
    if kind == "eeg":
        return DualEEGTransformer(**{k: v for k, v in EEG_MODEL.items() if k != "num_labels"},
                                  max_len=128, **kw)
    if kind == "gaze":
        return EarlyFusionViT(**GAZE, **kw)
    if kind == "art":
        return ArtifactRemovalTransformer(ArtConfig(**ART), **kw)
    if kind == "multimodal":
        return MultimodalFusionModel(**MULTIMODAL, **kw)
    return HyperEEGEncoder(**HYPEREEG, **kw)


def write_checkpoints(root: str) -> dict:
    """Each kind's checkpoint (state_dict + meta) under ``root``."""
    metas = {"eeg": {"model": EEG_MODEL, "data": {"sampling_rate": 256.0}},
             "gaze": {"model": {"kind": "early", "num_labels": 3, "img_size": IMG,
                                "fusion_mode": "concat", "vit_num_heads": 4}},
             "art": {"model": ART},
             "multimodal": {"model": {"multimodal": MULTIMODAL}},
             "hypereeg": {"model": {"hypereeg": HYPEREEG}}}
    paths = {}
    for kind in KINDS:
        path = Path(root) / f"{kind}.pt"
        torch.save(served_model(kind).state_dict(), path)
        path.with_suffix(".meta.json").write_text(json.dumps({"config": metas[kind]}))
        paths[kind] = str(path)
    return paths


def serve_inputs(kind: str, n: int = 5, seed: int = 0) -> tuple:
    r = np.random.default_rng(seed)
    if kind in ("eeg", "hypereeg"):
        return tuple(r.normal(size=(n, C, T)).astype(np.float32) for _ in range(2))
    imgs = tuple(r.integers(0, 256, (n, 3, IMG, IMG), dtype=np.uint8) for _ in range(2))
    if kind == "gaze":
        return imgs
    if kind == "art":
        return (r.normal(size=(n, ART_C, ART_T)).astype(np.float32),)
    return imgs + tuple(r.normal(size=(n, C, 128)).astype(np.float32) for _ in range(2))


_CLASSES = {"eeg": serving.Predictor, "gaze": serving.GazePredictor, "art": serving.ArtDenoiser,
            "multimodal": serving.MultimodalPredictor, "hypereeg": serving.HyperEEGPredictor}


def serve_all(paths: dict, mesh, device) -> dict:
    """Each kind served in float32 (the model built and loaded) and in bf16
    (``from_checkpoint``) on ``mesh`` (None: one process): the first output
    of each request."""
    out = {}
    for kind in KINDS:
        cls = _CLASSES[kind]
        model = served_model(kind)
        model.load_state_dict(torch.load(paths[kind], weights_only=True), strict=True)
        f32 = cls(model, device=device, batch_buckets=(2, 4), mesh=mesh)
        bf16 = cls.from_checkpoint(paths[kind], device=device, batch_buckets=(2, 4), mesh=mesh)
        key = "denoised" if kind == "art" else "logits"
        x = serve_inputs(kind)
        out[kind] = {"f32": f32.predict(*x)[key], "bf16": bf16.predict(*x)[key],
                     "buckets": bf16.buckets}
    return out


def serving_checks(rank: int, world: int, device, payload: dict) -> dict:
    """tests/test_torch_tensor_parallel_serving.py's checks on two ranks:
    the five kinds at dp1,tp2 and at dp2; a batch-z-score ART model refused
    at dp2 and served at dp1,tp2."""
    out = {"tp": serve_all(payload["paths"], "dp1,tp2", device),
           "dp": serve_all(payload["paths"], "dp2", device)}
    model = ArtifactRemovalTransformer(ArtConfig(**ART, recon_zscore="batch"), device=device,
                                       generator=torch.Generator().manual_seed(0))
    try:
        serving.ArtDenoiser(model, device=device, mesh="dp2")
    except ValueError as e:
        out["art_batch_dp2"] = str(e)
    pred = serving.ArtDenoiser(model, device=device, batch_buckets=(4,), mesh="dp1,tp2")
    out["art_batch_tp"] = {"buckets": pred.buckets,
                           "denoised": pred.predict(*serve_inputs("art"))["denoised"]}
    return out


def art_batch_one_process() -> np.ndarray:
    model = ArtifactRemovalTransformer(ArtConfig(**ART, recon_zscore="batch"),
                                       device=torch.device("cpu"),
                                       generator=torch.Generator().manual_seed(0))
    pred = serving.ArtDenoiser(model, device=torch.device("cpu"))
    return pred.predict(*serve_inputs("art"))["denoised"]

