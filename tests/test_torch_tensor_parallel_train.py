"""Tensor-parallel training in the port (``parallel/tensor.py`` under the
``Trainer``) against one process and against JAX, on the CPU.

Two gloo ranks (``tp2``) and four (``dp2,tp2``), each started once for the
module by ``parallel.launch`` (``tests/_torch_tp_ranks.py``):

- one Trainer step (learning rate 0, no clip) of the tiny flagship (d_model
  32, 4 heads, cross-brain attention on, the bench's five-term objective),
  the tiny early-fusion ViT and tiny ART (4 heads each) from weights
  converted from the JAX models, float32 without dropout: the loss within
  LOSS_RTOL of one process's and the gathered gradients within GRAD_SHARE
  of each tensor's largest entry; against JAX's gradients on a (1, 2)
  mesh with its parameters sharded by ``shard_tp`` (the 8-device virtual
  mesh of tests/conftest.py), at the bounds the one-process tests hold the
  port to (tests/test_torch_parallel.py's 1e-5 for the flagship,
  tests/test_torch_art_train.py's and tests/test_torch_gaze_train.py's
  1e-4 for ART and the ViT).  The key projections' biases, zero in exact
  arithmetic, within 1e-6 of the largest gradient;
- the layers' all_reduces per step: one per sharded block in the forward
  pass, one per copy into a tp region in the backward pass;
- at dropout 0.1, three steps leave the replicated parameters bit-equal
  across the tp ranks of a data rank;
- ART's tp2 checkpoint loads ``strict=True`` into one process, equals one
  process's after the same epoch, resumes under tp2 to the same numbers as
  the run that wrote it, and a one-process checkpoint resumes under tp2 as
  in one process.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_tp_ranks as ranks
from eyegaze_tpu.config import config_from_dict as jax_config_from_dict
from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.art import art_loss as jax_art_loss
from eyegaze_tpu.models.vit import EarlyFusionViT as JaxEarlyFusionViT
from eyegaze_tpu.parallel.sharding import make_mesh_2d, shard_tp
from eyegaze_tpu.train import losses as jax_losses
from eyegaze_tpu_torch import parallel
from eyegaze_tpu_torch.models import convert
from eyegaze_tpu_torch.train.optim import make_optimizer
from eyegaze_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
LOSS_RTOL = 1e-6
GRAD_SHARE = 1e-5
JAX_SHARE = {"flagship": 1e-5, "vit": 1e-4, "art": 1e-4}
ZERO_SHARE = 1e-6
B = 8
# Forward reduces + backward copies a step: the flagship's encoder block
# on each of the two streams (2 x (2 + 2)) and its cross-brain attention
# called in both directions (2 + 4: each call copies its two inputs);
# the ViT's 2 blocks (2 + 2 each); ART's encoder block (2 + 2) and decoder
# block (3 + 4: its cross attention copies x and memory).
ALL_REDUCES = {"flagship": 14, "vit": 8, "art": 11}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(seed):
    r = np.random.default_rng(seed)
    eeg = {k: r.normal(size=(B, ranks.C, ranks.T)).astype(np.float32) for k in ("eeg1", "eeg2")}
    eeg["label"] = (np.arange(B) % 3).astype(np.int32)
    imgs = {k: r.normal(size=(B, 3, ranks.IMG, ranks.IMG)).astype(np.float32)
            for k in ("img1", "img2")}
    imgs["label"] = (np.arange(B) % 3).astype(np.int32)
    clean = r.normal(size=(B, ranks.ART_C, ranks.ART_T)).astype(np.float32)
    art = {"input_values": clean + 0.5 * r.normal(size=clean.shape).astype(np.float32),
           "labels": clean}
    return {"flagship": eeg, "vit": imgs, "art": art}


def _jax_flagship():
    """The JAX script's model for the flagship's config, its initial
    parameters and the bench's five-term loss (deterministic), as
    tests/test_torch_parallel.py builds them."""
    spec = importlib.util.spec_from_file_location("jax_train_dual_eeg",
                                                  ROOT / "scripts" / "train_dual_eeg.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    jm = script.build_model(jax_config_from_dict(ranks.FLAGSHIP))
    z = jnp.zeros((1, ranks.C, ranks.T), jnp.float32)
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

    return params, loss_fn


def _jax_models():
    """(model, initial params, loss(params, batch)) of each family."""
    fparams, floss = _jax_flagship()
    vm = JaxEarlyFusionViT(**ranks.VIT)
    z = jnp.zeros((1, 3, ranks.IMG, ranks.IMG), jnp.float32)
    vparams = jax.jit(vm.init)(jax.random.PRNGKey(1), z, z)["params"]

    def vloss(p, b):
        return jax_losses.cross_entropy(vm.apply({"params": p}, b["img1"], b["img2"]), b["label"])

    am = JaxArt(JaxArtConfig(**ranks.ART))
    za = jnp.zeros((1, ranks.ART_C, ranks.ART_T), jnp.float32)
    aparams = jax.jit(am.init)(jax.random.PRNGKey(2), za, za)["params"]

    def aloss(p, b):
        recon = am.apply({"params": p}, b["input_values"], b["labels"], deterministic=True)
        return jax_art_loss(recon, b["labels"], loss_zscore=False)

    return {"flagship": (fparams, floss), "vit": (vparams, vloss), "art": (aparams, aloss)}


CONVERT = {"flagship": convert.dual_eeg_state_dict_from_flax,
           "vit": convert.gaze_early_state_dict_from_flax,
           "art": convert.art_state_dict_from_flax}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's tp2 steps, one process's steps and checkpoint, and the ranks'
    results at tp2 and at dp2,tp2."""
    batches = _batches(0)
    mesh = make_mesh_2d(1, 2)
    states, jax_steps = {}, {}
    for family, (params, loss) in _jax_models().items():
        params = jax.tree_util.tree_map(np.asarray, params)
        states[family] = CONVERT[family](params)
        batch = jax.tree_util.tree_map(jnp.asarray, batches[family])
        value, grads = jax.jit(jax.value_and_grad(loss))(shard_tp(params, mesh), batch)
        jax_steps[family] = {"loss": float(value), "grads": CONVERT[family](
            jax.tree_util.tree_map(np.asarray, grads))}
    one = {f: ranks.step(f, states[f], batches[f], None, CPU) for f in ranks.FAMILIES}
    art_epoch = [_batches(s)["art"] for s in (1, 2)]
    one_ckpt = tmp_path_factory.mktemp("one_ckpt")
    one_ckpt_run = ranks.checkpoint_run(states["art"], art_epoch, None, CPU, str(one_ckpt))
    payload = {"mesh": "tp2", "states": states, "batches": batches, "dropout": True,
               "dropout_batches": {f: [_batches(s)[f] for s in (3, 4, 5)]
                                   for f in ranks.FAMILIES},
               "art_epoch": art_epoch, "ckpt_dir": str(tmp_path_factory.mktemp("tp_ckpt")),
               "one_process_ckpt_dir": str(one_ckpt)}
    tp2 = parallel.launch(ranks.train_checks, 2, payload,
                          store_dir=tmp_path_factory.mktemp("store2"))
    dp2tp2 = parallel.launch(ranks.train_checks, 4, {"mesh": "dp2,tp2", "states": states,
                                                     "batches": batches},
                             store_dir=tmp_path_factory.mktemp("store4"))
    return {"jax": jax_steps, "one": one, "tp2": tp2, "dp2,tp2": dp2tp2, "states": states,
            "art_epoch": art_epoch, "one_ckpt_run": one_ckpt_run, "payload": payload}


def test_ranks_sit_on_the_mesh_model_axis_innermost(runs):
    assert [(r["data"], r["tp"]) for r in runs["tp2"]] == [((0, 1), (0, 2)), ((0, 1), (1, 2))]
    assert [(r["data"], r["tp"]) for r in runs["dp2,tp2"]] == [
        ((d, 2), (t, 2)) for d in range(2) for t in range(2)]


def _assert_grads(got: dict, want: dict, share: float, what: str) -> None:
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        # Zero in exact arithmetic: the key biases (the ViT's in qkv.bias).
        zero = k.endswith("k_proj.bias") or k.endswith("qkv.bias")
        atol = (ZERO_SHARE if k.endswith("k_proj.bias") else share) * (
            largest if zero else np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("mesh", ["tp2", "dp2,tp2"])
@pytest.mark.parametrize("family", ranks.FAMILIES)
def test_step_matches_one_process_and_jax(runs, family, mesh):
    one, jax_step = runs["one"][family], runs["jax"][family]
    np.testing.assert_allclose(one["loss"], jax_step["loss"], rtol=LOSS_RTOL)
    for out in runs[mesh]:
        got = out["steps"][family]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["loss"], jax_step["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=LOSS_RTOL)
        _assert_grads(got["grads"], one["grads"], GRAD_SHARE, "one process")
        _assert_grads(got["grads"], jax_step["grads"], JAX_SHARE[family], "JAX")
        assert got["all_reduces"] == ALL_REDUCES[family]
        assert got["numel"] < one["numel"]  # the rank holds its shards
    assert one["all_reduces"] == 0


@pytest.mark.parametrize("family", ranks.FAMILIES)
def test_dropout_keeps_replicated_parameters_equal_across_tp_ranks(runs, family):
    first, second = (r["dropout"][family] for r in runs["tp2"])
    assert first["sharded"] == second["sharded"] and first["sharded"]
    assert first["replicated"].keys() == second["replicated"].keys()
    for k, v in first["replicated"].items():
        np.testing.assert_array_equal(v, second["replicated"][k], err_msg=k)


def _assert_trained(got: dict, want: dict, steps: int, what: str) -> None:
    """Parameters after ``steps`` AdamW steps of lr 1e-3: each within
    GRAD_SHARE of its largest entry; a key bias (zero gradient in exact
    arithmetic, so AdamW's step follows rounding noise) within the steps'
    reach, ``steps`` times the learning rate."""
    for k, w in want.items():
        atol = (steps * 1e-3 if k.endswith("k_proj.bias")
                else GRAD_SHARE * max(np.abs(w).max(), 1e-3))
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=f"{what}: {k}")


def test_tp_checkpoint_loads_into_one_process_and_resumes(runs):
    ckpt = runs["payload"]["ckpt_dir"]
    epoch = len(runs["art_epoch"])
    state = torch.load(f"{ckpt}/checkpoint_epoch_0.pt", weights_only=True)
    model = ranks.build("art", None, CPU)
    model.load_state_dict(state, strict=True)
    one = torch.load(f"{runs['payload']['one_process_ckpt_dir']}/checkpoint_epoch_0.pt",
                     weights_only=True)
    _assert_trained({k: v.numpy() for k, v in state.items()},
                    {k: v.numpy() for k, v in one.items()}, epoch, "tp2 vs one process")
    want = runs["one_ckpt_run"]["trained"]
    for out in runs["tp2"]:
        ck = out["checkpoint"]
        assert ck["steps"] == 2 * epoch
        for k, v in ck["trained"].items():  # resumed under tp2: the same numbers
            np.testing.assert_array_equal(ck["resumed"][k], v, err_msg=k)
        _assert_trained(out["resumed_one_process"], want, 2 * epoch,
                        "one process's checkpoint resumed under tp2")
    # The tp2 checkpoint resumes in one process, to the tp2 run's numbers.
    model = ranks.build("art", runs["states"]["art"], CPU)
    trainer = Trainer(model, make_optimizer(model, 1e-3), ranks.loss_fn("art"), None,
                      TrainerConfig(checkpoint_dir=ckpt, prefetch=0), device=CPU)
    assert trainer.restore("checkpoint_epoch_0") == epoch
    trainer.train_epoch(runs["art_epoch"], 1)
    _assert_trained({k: v.numpy() for k, v in model.state_dict().items()},
                    runs["tp2"][0]["checkpoint"]["trained"], 2 * epoch,
                    "tp2 checkpoint resumed in one process")
