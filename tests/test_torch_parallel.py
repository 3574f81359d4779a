"""The port's data parallelism (``eyegaze_tpu_torch.parallel``) against the
JAX package's ``parallel/`` and against one process.

- ``parse_mesh_spec``, ``process_shard_bounds`` and ``global_batch_size``
  against the JAX functions over a table of cases, errors included (tp
  specs too: the port has the tensor-parallel axis).
- Two gloo ranks on the CPU, started once for the module by
  ``parallel.launch`` (``tests/_torch_parallel_ranks.py``), through a
  ``file://`` store under the test's temporary directory:
  - ``gather_rows``: every rank's rows in rank order, and the gradient of a
    rank's rows the sum over the ranks of the gathered tensor's;
  - the flagship's five-term objective (CE + 0.1 symmetry + 0.1 IBS
    alignment + 0.3 IBS-CE + 0.1 IBS contrastive) on a global batch of 8,
    4 rows a rank, its gradient averaged by DDP against ``jax.grad`` of the
    JAX loss on the whole batch, from the same converted weights, float32
    without dropout, at the geometry of tests/test_parallel.py:186-196.
    Every tensor within GRAD_RTOL of its largest |entry| (the float32 sums
    of two shards against one, measured 1.7e-6 at most); the key projections'
    biases, zero in exact arithmetic, within 1e-6 of the largest gradient.
    The same step with each rank's rows alone in the coupled losses misses
    the bound by orders of magnitude: the test sees the loss the gather
    restores;
  - ART's eval metrics (the SNRs are ratios of sums over the batch) and the
    flagship's eval over a ragged batch of 5 rows and a batch of 1 (a rank
    with no valid row) equal one process's; with ``local_batches`` the ranks'
    own batches (3 and 1 rows) score as their concatenation, also where
    rank 1's batches run out first;
  - ``all_processes_concat`` with a rank that holds no row;
  - the gathers' own group, apart from DDP's;
  - an objective that leaves the IBS head without a gradient: a Trainer
    step raises without ``find_unused_parameters`` and, with it, gives one
    process's gradient norm;
  - ``--multihost`` with uneven train shards (``common_steps``): every
    rank trains the smallest shard's steps; batches of other row counts
    raise on every rank; a pre-split layout is sharded by trials (the JAX
    script loads all of it in every process).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_parallel_ranks as ranks
from eyegaze_tpu.config import config_from_dict as jax_config_from_dict
from eyegaze_tpu.parallel import multihost as jax_multihost
from eyegaze_tpu.parallel import sharding as jax_sharding
from eyegaze_tpu.train import losses as jax_losses
from eyegaze_tpu_torch import parallel, train_art, train_dual_eeg
from eyegaze_tpu_torch.config import config_from_dict
from eyegaze_tpu_torch.models.convert import dual_eeg_state_dict_from_flax
from eyegaze_tpu_torch.train.optim import make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig
from eyegaze_tpu_torch.train_dual_eeg import BENCH_LOSSES

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
WORLD = 2
C, T, B = 8, 256, 8
GRAD_RTOL = 1e-5
ZERO_GRAD_SHARE = 1e-6
# tests/test_parallel.py:186-196, without dropout, with the bench's objective.
CFG = {"model": {"in_channels": C, "d_model": 32, "num_layers": 1, "num_heads": 4, "d_ff": 64},
       "ablation": {"use_spectrogram": False, "use_ibs": True, "ibs_mode": "robust",
                    "use_cross_attention": False},
       "data": {"window_size": T, "stride": 384, "sampling_rate": 256.0},
       "training": {"dropout": 0.0, "bf16": False, **BENCH_LOSSES},
       "system": {"seed": 42}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPECS = [(True, 4), (None, 3), ("", 2), ("dp", 4), ("DP2", 4), ("dp4", 4), ("dp1", 1),
         ("dp,", 2), ("dp8", 4), ("tp2", 4), ("dp2,tp2", 4), ("tp4", 2), ("dp3,tp2", 4),
         ("tp", 2), ("xp2", 2), ("dp2,tpx", 4), (3, 2)]


@pytest.mark.parametrize("spec,n", SPECS, ids=[f"{s!r}-{n}" for s, n in SPECS])
def test_parse_mesh_spec_matches_jax(spec, n):
    try:
        want = jax_sharding.parse_mesh_spec(spec, n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parallel.parse_mesh_spec(spec, n)
        assert str(got.value) == str(e)
        return
    assert parallel.parse_mesh_spec(spec, n) == want


BOUNDS = [(32, 0, 4), (32, 3, 4), (10, 1, 2), (10, 0, 1), (30, 0, 4), (7, 2, 3)]


@pytest.mark.parametrize("n,pi,pc", BOUNDS, ids=[f"{n}-{pi}of{pc}" for n, pi, pc in BOUNDS])
def test_process_shard_bounds_matches_jax(n, pi, pc):
    try:
        want = jax_multihost.process_shard_bounds(n, process_index=pi, process_count=pc)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parallel.process_shard_bounds(n, process_index=pi, process_count=pc)
        assert str(got.value) == str(e)
        return
    assert parallel.process_shard_bounds(n, process_index=pi, process_count=pc) == want


def test_one_process_defaults_match_jax():
    """Without a group: rank 0 of 1, as the JAX functions in one process."""
    assert parallel.process_shard_bounds(10) == jax_multihost.process_shard_bounds(10) == (0, 10)
    assert parallel.global_batch_size(16) == jax_multihost.global_batch_size(16) == 16
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(parallel.all_processes_concat(x),
                                  jax_multihost.all_processes_concat(x))
    t = torch.ones(2, 3, requires_grad=True)
    assert parallel.gather_rows(t) is t


def _jax_flagship():
    """The JAX script's model for CFG, its initial parameters and the
    five-term loss (deterministic)."""
    spec = importlib.util.spec_from_file_location("jax_train_dual_eeg",
                                                  ROOT / "scripts" / "train_dual_eeg.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jm = script.build_model(jax_config_from_dict(CFG))
    z = jnp.zeros((1, C, T), jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), z, z)["params"]

    def loss_fn(p, batch):
        out = jm.apply({"params": p}, batch["eeg1"], batch["eeg2"], deterministic=True)
        labels = batch["label"]
        loss = jax_losses.cross_entropy(out["logits"], labels)
        loss += 0.1 * jax_losses.symmetry_loss(out["cls1"], out["cls2"])
        loss += 0.1 * jax_losses.ibs_alignment_loss(out["ibs_token"], out["cls1"], out["cls2"])
        loss += 0.3 * jax_losses.cross_entropy(out["ibs_logits"], labels)
        loss += 0.1 * jax_losses.ibs_contrastive_loss(out["ibs_token"], labels)
        return loss

    return jm, jax.tree_util.tree_map(np.asarray, params), loss_fn


def _eeg_batch(seed, n):
    r = np.random.default_rng(seed)
    e1, e2 = (r.normal(size=(n, C, T)).astype(np.float32) for _ in range(2))
    return {"eeg1": e1, "eeg2": e2, "label": (np.arange(n) % 3).astype(np.int32)}


def _art_batch(seed, n):
    r = np.random.default_rng(seed)
    clean = r.normal(size=(n, ranks.ART_C, ranks.ART_T)).astype(np.float32)
    return {"input_values": clean + 0.5 * r.normal(size=clean.shape).astype(np.float32),
            "labels": clean}


def _multihost_cfg(out_dir) -> dict:
    """CFG on 9 synthetic trials (each shard 3 train trials and 1
    validation trial of 3 windows), local batches of 4."""
    return {**CFG, "data": {**CFG["data"], "synthetic": True, "synthetic_trials": 9},
            "training": {**CFG["training"], "num_train_epochs": 1,
                         "per_device_train_batch_size": 4, "per_device_eval_batch_size": 4,
                         "output_dir": str(out_dir)},
            "system": {"seed": 42, "device": "cpu", "mesh": "dp"}}


def _pre_split_layout(eeg_dir: Path) -> str:
    """train_*.npy of 5 trials (pairs 10-14) and val_*.npy of 2 (20-21), of
    3 windows each."""
    r = np.random.default_rng(5)
    for split, pairs in (("train", np.arange(10, 15)), ("val", np.arange(20, 22))):
        for name in ("eeg1", "eeg2"):
            np.save(eeg_dir / f"{split}_{name}.npy",
                    r.normal(size=(len(pairs), C, 1024)).astype(np.float32))
        np.save(eeg_dir / f"{split}_labels.npy", (pairs % 3).astype(np.int32))
        np.save(eeg_dir / f"{split}_pairs.npy", pairs)
    return str(eeg_dir)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The JAX reference and the two ranks' results."""
    _, params, loss_fn = _jax_flagship()
    batch = _eeg_batch(0, B)
    grads = jax.jit(jax.grad(loss_fn))(params, jax.tree_util.tree_map(jnp.asarray, batch))
    payload = {"cfg": CFG, "state": dual_eeg_state_dict_from_flax(params), "batch": batch,
               "art_batches": [_art_batch(1, 5), _art_batch(2, 3)],
               "eval_batches": [_eeg_batch(3, 5), _eeg_batch(4, 1)],
               "multihost_cfg": _multihost_cfg(tmp_path_factory.mktemp("multihost")),
               "pre_split_dir": _pre_split_layout(tmp_path_factory.mktemp("pre_split"))}
    got = parallel.launch(ranks.checks, WORLD, payload,
                          store_dir=tmp_path_factory.mktemp("store"))
    want = dual_eeg_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    return {"payload": payload, "ranks": got, "jax_grads": want}


def test_ranks_join_one_group(world2):
    assert [r["rank_and_world"] for r in world2["ranks"]] == [(0, WORLD), (1, WORLD)]
    assert [r["rows_group"] for r in world2["ranks"]] == [(True, WORLD)] * WORLD
    assert not parallel.active()  # the launching process joins nothing


def test_gather_rows_forward_and_backward(world2):
    x = np.arange(18, dtype=np.float32).reshape(6, 3)
    w = x[None] * np.arange(1, WORLD + 1, dtype=np.float32)[:, None, None]
    for r, out in enumerate(world2["ranks"]):
        g = out["gather"]
        np.testing.assert_array_equal(g["gathered"], x)
        np.testing.assert_array_equal(g["labels"], np.arange(6))
        np.testing.assert_array_equal(g["bf16"], x)
        assert g["bf16_dtype"] == "torch.bfloat16"
        # d/d(rows of rank r) of sum_s sum(gathered * W_s): sum_s W_s[rows_r].
        np.testing.assert_array_equal(g["grad"], w.sum(axis=0)[3 * r:3 * (r + 1)])


def _grad_gaps(got: dict, want: dict) -> dict:
    """Each tensor's largest |got - want| over its bound."""
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    return {k: np.abs(got[k] - w).max() / (ZERO_GRAD_SHARE * largest if k.endswith("k_proj.bias")
                                           else GRAD_RTOL * np.abs(w).max())
            for k, w in want.items()}


def test_flagship_gradient_over_two_ranks_matches_jax(world2):
    want = world2["jax_grads"]
    for out in world2["ranks"]:  # DDP's average: the same gradient on both ranks
        gaps = _grad_gaps(out["grads"], want)
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= 1.0, (worst, gaps[worst])


def test_flagship_gradient_without_the_gather_misses_jax(world2):
    """Each rank's 4 rows alone as the alignment loss's negatives and the
    contrastive loss's positives: a different loss, far outside the bound."""
    gaps = _grad_gaps(world2["ranks"][0]["grads_without_gather"], world2["jax_grads"])
    assert max(gaps.values()) > 100.0


def test_art_eval_metrics_over_two_ranks_equal_one_process(world2):
    model = ranks.art_model(CPU)
    _, metrics_fn = train_art.make_objective(False)
    trainer = Trainer(model, make_optimizer(model, 1e-3), lambda m, b: None, None,
                      TrainerConfig(prefetch=0), device=CPU, eval_metrics_fn=metrics_fn)
    want = trainer.evaluate(world2["payload"]["art_batches"])
    assert set(want) == {"val/loss", "val/snr_in_db", "val/snr_out_db",
                         "val/snr_improvement_db"}
    for out in world2["ranks"]:
        assert out["art_eval"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(out["art_eval"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def _one_process_eval(batches, state):
    model = ranks.flagship_model(CFG, state, CPU)
    _, eval_fn = train_dual_eeg.make_objective(config_from_dict(CFG))
    trainer = Trainer(model, make_optimizer(model, 1e-3), lambda m, b: None, eval_fn,
                      TrainerConfig(prefetch=0), device=CPU)
    return trainer.evaluate(batches), trainer.eval_logits


@pytest.mark.parametrize("key", ["eval", "local_eval", "uneven_local_eval"],
                         ids=["global_batches", "local_batches", "uneven_local_batches"])
def test_ragged_eval_and_a_rank_without_rows(world2, key):
    """Global batches of 5 rows (padded to 6) and 1 row (rank 1 holds only
    padding); with ``local_batches`` rank 0's 3 rows and rank 1's 1 row of
    each batch, scored as their concatenation; "uneven": rank 1 holds the
    first batch alone, the second is rank 0's rows alone."""
    batches = world2["payload"]["eval_batches"]
    if key != "eval":
        batches = [{k: np.concatenate([v[:3], v[:1]] if i == 0 or key == "local_eval"
                                      else [v[:3]]) for k, v in b.items()}
                   for i, b in enumerate(batches)]
    metrics, logits = _one_process_eval(batches, world2["payload"]["state"])
    for out in world2["ranks"]:
        got = out[key]
        assert got["logits"].shape == logits.shape
        np.testing.assert_allclose(got["logits"], logits, rtol=0, atol=1e-5)
        assert got["metrics"].keys() == metrics.keys()
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, atol=1e-6, err_msg=k)


def test_all_processes_concat_with_a_rank_without_rows(world2):
    for out in world2["ranks"]:
        np.testing.assert_array_equal(out["concat"], np.ones((2, 2)))


def test_a_parameter_without_gradient_needs_find_unused_parameters(world2):
    """Without the IBS cross entropy the IBS head gets no gradient, so DDP
    averages none of its bucket: the step raises on every rank, and with
    ``find_unused_parameters`` its gradient norm is one process's."""
    cfg = {**CFG, "training": {**CFG["training"], "use_ibs_cls_loss": False}}
    model = ranks.flagship_model(cfg, world2["payload"]["state"], CPU)
    loss_fn, _ = train_dual_eeg.make_objective(config_from_dict(cfg))
    trainer = Trainer(model, make_optimizer(model, 1e-3), loss_fn, None, TrainerConfig(prefetch=0),
                      device=CPU)
    want = trainer.train_epoch([world2["payload"]["batch"]], 0)["train/grad_norm"]
    for out in world2["ranks"]:
        got = out["unused_head"]
        assert "find_unused_parameters=True" in got[False] and "ibs_classifier" in got[False]
        np.testing.assert_allclose(got[True], want, rtol=GRAD_RTOL)


def test_common_steps_is_the_smallest_shards(world2):
    for out in world2["ranks"]:
        assert out["common_steps"]["steps"] == 3
        assert "hold [4, 2] rows" in out["common_steps"]["rows_error"]


def test_uneven_multihost_shards_train_the_same_steps(world2):
    """Rank 1's train shard holds one batch, rank 0's two: both take one
    step (without ``common_steps`` rank 0 would wait on its second step's
    gradients until the group's timeout)."""
    r0, r1 = (out["uneven_multihost"] for out in world2["ranks"])
    assert r0["steps"] == r1["steps"] == 1
    assert len(r0["history"]) == 1 and np.isfinite(r0["history"][0]["train/loss"])
    assert r0["history"][0]["train/loss"] == r1["history"][0]["train/loss"]


def test_multihost_shards_a_pre_split_layout(world2):
    """5 train trials trimmed to 4, 2 a rank; 1 validation trial a rank."""
    for r, out in enumerate(world2["ranks"]):
        assert out["pre_split"] == {"train": [10 + 2 * r, 11 + 2 * r], "val": [20 + r],
                                    "windows": 6}
