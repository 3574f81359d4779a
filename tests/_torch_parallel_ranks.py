"""Rank functions of the data-parallelism tests (tests/test_torch_parallel*.py).

``eyegaze_tpu_torch.parallel.launch`` pickles a rank function by its module
and name, so the ranks import this module, which imports torch and the port
only: a rank starts without jax.  ``checks`` runs every world-2 check of
tests/test_torch_parallel.py in one launch and returns what the test process
compares; ``gaze_without_augment`` and ``hypereeg_without_dropout`` run an
entry point's ``run`` with its randomness off, on a rank or in one process.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from eyegaze_tpu_torch import parallel, train_art, train_dual_eeg, train_gaze, train_hypereeg
from eyegaze_tpu_torch.config import config_from_dict
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.train.optim import make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

# ART at a small width, on (n, ART_C, ART_T) windows.
ART_C, ART_T = 4, 64
ART = dict(in_channels=ART_C, out_channels=ART_C, embedding_size=32, num_encoder_layers=1,
           num_decoder_layers=1, num_heads=4, feedforward_size=64, max_len=ART_T)


def without_dropout(model: torch.nn.Module) -> torch.nn.Module:
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def art_model(device) -> ArtifactRemovalTransformer:
    return ArtifactRemovalTransformer(ArtConfig(**ART), device=device,
                                      generator=torch.Generator().manual_seed(3))


def flagship_model(cfg: dict, state: dict, device) -> torch.nn.Module:
    model = train_dual_eeg.build_model(config_from_dict(cfg), device=device)
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return without_dropout(model)


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` set to ``value`` inside the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def gaze_without_augment(*args, **kwargs) -> dict:
    """``train_gaze.run`` with the flip and colour jitter left out; its fit
    result."""
    with patched(train_gaze, "augment_gaze_pair", lambda generator, a, b: (a, b)):
        result = train_gaze.run(*args, **kwargs)
    return {k: result[k] for k in ("best_metric", "history")}


def hypereeg_without_dropout(*args, **kwargs) -> dict:
    """``train_hypereeg.run`` with the model's dropout at 0; its fit
    result."""
    build = functools.partial(train_hypereeg.build_model, dropout=0.0)
    with patched(train_hypereeg, "build_model", build):
        result = train_hypereeg.run(*args, **kwargs)
    return {k: result[k] for k in ("best_metric", "history")}


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _gather_checks(rank: int, world: int) -> dict:
    """gather_rows on each rank's rows of one global (6, 3) tensor: the
    gathered tensor, and the gradient of the rank's rows under a loss that
    differs per rank (sum_s W_s[rows_r] is the gathered tensor's)."""
    x = torch.arange(18, dtype=torch.float32).reshape(6, 3)
    mine = parallel.shard_rows(x, rank, world).clone().requires_grad_()
    w = torch.arange(18, dtype=torch.float32).reshape(6, 3) * (rank + 1)
    gathered = parallel.gather_rows(mine)
    (gathered * w).sum().backward()
    labels = parallel.gather_rows(parallel.shard_rows(torch.arange(6, dtype=torch.int32),
                                                      rank, world))
    half = parallel.gather_rows(parallel.shard_rows(x.to(torch.bfloat16), rank, world))
    return {"gathered": gathered.detach().numpy(), "grad": mine.grad.numpy(),
            "labels": labels.numpy(), "bf16": half.float().numpy(), "bf16_dtype": str(half.dtype)}


def _flagship_grads(cfg: dict, state: dict, batch: dict, rank: int, world: int,
                    device) -> dict:
    """The objective's gradient on the global ``batch`` through DDP, every
    parameter's averaged .grad by name."""
    model = flagship_model(cfg, state, device)
    ddp = parallel.data_parallel_module(model, device)
    loss_fn, _ = train_dual_eeg.make_objective(config_from_dict(cfg))
    loss, _ = loss_fn(ddp, tensors(parallel.shard_rows(batch, rank, world)))
    loss.backward()
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _art_eval(batches: list, device) -> dict:
    model = art_model(device)
    _, metrics_fn = train_art.make_objective(False)
    trainer = Trainer(model, make_optimizer(model, 1e-3), lambda m, b: None, None,
                      TrainerConfig(use_mesh="dp", prefetch=0), device=device,
                      eval_metrics_fn=metrics_fn)
    return trainer.evaluate(batches)


def _flagship_eval(cfg: dict, state: dict, batches: list, device, local: bool) -> dict:
    model = flagship_model(cfg, state, device)
    _, eval_fn = train_dual_eeg.make_objective(config_from_dict(cfg))
    trainer = Trainer(model, make_optimizer(model, 1e-3), lambda m, b: None, eval_fn,
                      TrainerConfig(use_mesh="dp", local_batches=local, prefetch=0),
                      device=device)
    metrics = trainer.evaluate(batches)
    return {"metrics": metrics, "logits": trainer.eval_logits}


def _unused_head(cfg: dict, state: dict, batch: dict, rank: int, world: int, device) -> dict:
    """One Trainer step of the objective without the IBS cross entropy (the
    IBS head gets no gradient): the error without ``find_unused_parameters``,
    the gradient norm with it."""
    cfg = {**cfg, "training": {**cfg["training"], "use_ibs_cls_loss": False}}
    loss_fn, _ = train_dual_eeg.make_objective(config_from_dict(cfg))
    out = {}
    for find in (False, True):
        model = flagship_model(cfg, state, device)
        trainer = Trainer(model, make_optimizer(model, 1e-3), loss_fn, None,
                          TrainerConfig(use_mesh="dp", find_unused_parameters=find, prefetch=0),
                          device=device)
        try:
            out[find] = trainer.train_epoch([batch], 0)["train/grad_norm"]
        except RuntimeError as e:
            out[find] = str(e)
    return out


def _common_steps(rank: int) -> dict:
    """``common_steps`` with 5 and 3 batches of 4 rows, then of 4 and 2."""
    out = {"steps": parallel.common_steps(5 - 2 * rank, 4)}
    try:
        parallel.common_steps(3, 4 - 2 * rank)
    except ValueError as e:
        out["rows_error"] = str(e)
    return out


def _uneven_multihost(cfg: dict, rank: int, device) -> dict:
    """``train_dual_eeg.run`` under ``--multihost`` with rank 1's train
    shard one trial short (6 windows against 9, one batch of 4 against
    two): every rank trains one step."""
    bounds = parallel.process_shard_bounds

    def short(n, *args, **kwargs):
        lo, hi = bounds(n, *args, **kwargs)
        return (lo, hi - 1) if (n, rank) == (6, 1) else (lo, hi)

    with patched(parallel, "process_shard_bounds", short):
        result = train_dual_eeg.run(config_from_dict(cfg), device=device, multihost=True)
    return {"history": result["history"], "steps": result["trainer"].optimizer.count}


def _pre_split_shard(cfg: dict, eeg_dir: str) -> dict:
    """This rank's trials (their pair IDs) of a pre-split layout under
    ``--multihost``'s ``process_shard``."""
    cfg = {**cfg, "data": {**cfg["data"], "eeg_base_path": eeg_dir}}
    train, val = train_dual_eeg.prepare_datasets(config_from_dict(cfg), process_shard=True)
    return {"train": train.pairs.tolist(), "val": val.pairs.tolist(), "windows": len(train)}


def checks(rank: int, world: int, device, payload: dict) -> dict:
    """Every check of the test module on this rank (``payload``: the
    flagship's config, converted weights and batches, ART's batches)."""
    rows = parallel.mesh._ROWS
    out = {"gather": _gather_checks(rank, world),
           "world": world, "rank_and_world": parallel.rank_and_world(),
           "rows_group": (rows is not torch.distributed.group.WORLD,
                          torch.distributed.get_world_size(rows))}
    cfg, state = payload["cfg"], payload["state"]
    out["grads"] = _flagship_grads(cfg, state, payload["batch"], rank, world, device)
    # The same step with each rank's rows alone in the coupled losses.
    gather = train_dual_eeg.gather_rows
    train_dual_eeg.gather_rows = lambda x: x
    try:
        out["grads_without_gather"] = _flagship_grads(cfg, state, payload["batch"], rank, world,
                                                      device)
    finally:
        train_dual_eeg.gather_rows = gather
    out["art_eval"] = _art_eval(payload["art_batches"], device)
    out["eval"] = _flagship_eval(cfg, state, payload["eval_batches"], device, local=False)
    # --multihost's eval: each rank its own batches, of other sizes.
    mine = [{k: v[:3 - 2 * rank] for k, v in b.items()} for b in payload["eval_batches"]]
    out["local_eval"] = _flagship_eval(cfg, state, mine, device, local=True)
    # Rank 0 holds both batches, rank 1 the first alone.
    out["uneven_local_eval"] = _flagship_eval(cfg, state, mine[:2 - rank], device, local=True)
    out["concat"] = parallel.all_processes_concat(np.full((2 * (1 - rank), 2), rank + 1.0))
    out["unused_head"] = _unused_head(cfg, state, payload["batch"], rank, world, device)
    out["common_steps"] = _common_steps(rank)
    out["uneven_multihost"] = _uneven_multihost(payload["multihost_cfg"], rank, device)
    out["pre_split"] = _pre_split_shard(cfg, payload["pre_split_dir"])
    return out
