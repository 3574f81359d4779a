"""The port's losses, metrics, LR schedules and AdamW against the JAX package.

Inputs are made from numpy seeds and passed to both sides as numpy arrays,
float32 throughout.  Tolerances:

- losses: 1e-6 absolute and relative (a few float32 roundings of O(1)
  values, summed over 8 rows in another order);
- confusion matrix exact; precision, recall, F1 and ROC/AUC within 1e-6;
- schedules: 1e-7 absolute (the port evaluates in float64, optax in
  float32: a few ulps of a 1e-3 LR);
- AdamW with clipping, fed the same gradients on both sides: parameters
  within rtol 1e-6 after three steps, so the optimizer's parity stands
  apart from the model's.  Plus an absolute term for optax's bias
  correction: it forms 1 - 0.999**t in float32, off by up to half an ulp
  of 1 (6e-8) against a value of 1e-3 t, so its sqrt(v_hat) is off by up
  to 3e-5 relative (torch forms it in float64).  Over the three steps that
  moves a parameter by at most 3e-5 * sum_k lr_k * |m_hat / sqrt(v_hat)|,
  and the Adam ratio stays below 3 here: atol 1e-4 * sum_k lr_k.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from eyegaze_tpu.train import losses as jax_losses
from eyegaze_tpu.train import metrics as jax_metrics
from eyegaze_tpu.train import optim as jax_optim
from eyegaze_tpu_torch.train import losses, metrics, optim

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed, *shapes):
    r = np.random.default_rng(seed)
    return [r.normal(size=s).astype(np.float32) for s in shapes]


LABEL_CASES = {
    "mixed": np.array([0, 1, 2, 0, 1, 2, 0, 2]),
    "no_positives": np.array([0, 1, 2, 3, 4, 5, 6, 7]),
    "one_row_alone": np.array([0, 0, 0, 1, 1, 1, 1, 2]),
}


@pytest.mark.parametrize("case", sorted(LABEL_CASES))
def test_losses_match_jax(case):
    labels = LABEL_CASES[case]
    logits, tokens, cls1, cls2 = _arrays(1, (8, 3), (8, 16), (8, 16), (8, 16))
    weights = np.array([0.5, 1.0, 2.0], np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(logits=logits, tokens=tokens, cls1=cls1, cls2=cls2, weights=weights).items()}
    lab = torch.from_numpy(labels)
    lab3 = torch.from_numpy(labels % 3)
    pairs = [
        (losses.cross_entropy(t["logits"], lab3),
         jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels % 3))),
        (losses.weighted_cross_entropy(t["logits"], lab3, t["weights"]),
         jax_losses.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(labels % 3),
                                           jnp.asarray(weights))),
        (losses.symmetry_loss(t["cls1"], t["cls2"]),
         jax_losses.symmetry_loss(jnp.asarray(cls1), jnp.asarray(cls2))),
        (losses.ibs_alignment_loss(t["tokens"], t["cls1"], t["cls2"]),
         jax_losses.ibs_alignment_loss(jnp.asarray(tokens), jnp.asarray(cls1), jnp.asarray(cls2))),
        (losses.ibs_contrastive_loss(t["tokens"], lab),
         jax_losses.ibs_contrastive_loss(jnp.asarray(tokens), jnp.asarray(labels))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(float(got), float(want), **TOL, err_msg=str(i))
    if case == "no_positives":
        assert float(pairs[-1][0]) == 0.0


def test_l2norm_floor_keeps_zero_tokens_finite():
    tokens = np.zeros((4, 8), np.float32)
    labels = np.array([0, 0, 1, 1])
    got = losses.ibs_contrastive_loss(torch.from_numpy(tokens), torch.from_numpy(labels))
    want = jax_losses.ibs_contrastive_loss(jnp.asarray(tokens), jnp.asarray(labels))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_classification_metrics_match_jax():
    r = np.random.default_rng(2)
    labels = r.integers(0, 3, 50)
    preds = np.where(r.random(50) < 0.6, labels, r.integers(0, 2, 50))  # class 2 under-predicted
    preds[preds == 2] = 0  # class 2 never predicted: zero_division = 0
    got = metrics.classification_metrics(labels, preds, 3)
    want = jax_metrics.classification_metrics(jnp.asarray(labels), jnp.asarray(preds), 3)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["confusion_matrix"], np.asarray(want["confusion_matrix"]))
    for k in want:
        if k != "confusion_matrix":
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), **TOL, err_msg=k)
    assert float(got["precision_per_class"][2]) == 0.0


def test_roc_curves_match_jax():
    r = np.random.default_rng(3)
    labels = r.integers(0, 3, 40)
    probs = np.round(r.dirichlet(np.ones(3), 40), 1)  # rounded: tied scores
    got, want = metrics.roc_curves(labels, probs), jax_metrics.roc_curves(labels, probs)
    np.testing.assert_allclose(got["macro_auc"], want["macro_auc"], **TOL)
    for k in range(3):
        for key in ("fpr", "tpr", "auc"):
            np.testing.assert_allclose(got["per_class"][k][key], want["per_class"][k][key], **TOL)
    for key in ("fpr", "tpr", "auc"):
        np.testing.assert_allclose(got["micro"][key], want["micro"][key], **TOL)


@pytest.mark.parametrize("kind, args, steps", [
    ("warmup_cosine", (1e-3, 5, 50, 0.1), (0, 1, 4, 5, 6, 25, 49, 50, 80)),
    ("warmup_cosine", (3e-4, 0, 20, 0.0), (0, 1, 10, 19, 20, 30)),
    ("cosine_annealing", (1e-4, 10, 7), (0, 6, 7, 13, 35, 69, 70, 100)),
])
def test_schedules_match_optax(kind, args, steps):
    got = getattr(optim, f"{kind}_schedule")(*args)
    want = getattr(jax_optim, f"{kind}_schedule")(*args)
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(jnp.asarray(s))), rtol=0, atol=1e-7,
                                   err_msg=f"step {s}")


def test_clip_takes_optax_form():
    """Below the bound the gradient is untouched; above it, g / norm * max."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    assert float(optim.clip_by_global_norm_(g, 10.0)) == 5.0
    assert g[0].tolist() == [3.0, 4.0]
    norm = optim.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(g[0], torch.tensor([3.0, 4.0]) / 5.0 * 1.0, rtol=0, atol=0)


PARAM_SHAPES = {"enc_w": (4, 3), "enc_b": (3,), "head_w": (3, 2), "head_b": (2,),
                "frozen_w": (2, 2)}


@pytest.mark.parametrize("grouped", [False, True], ids=["one_group", "groups_and_frozen"])
def test_adamw_with_clipping_matches_optax(grouped):
    r = np.random.default_rng(4)
    params = {k: r.normal(size=s).astype(np.float32) for k, s in PARAM_SHAPES.items()}
    params["head_b"][:] = 0.0  # a zero start, as Flax's biases
    # Step 0 and 2 clip (norm > 1), step 1 does not.
    grads = [{k: (r.normal(size=s) * scale).astype(np.float32) for k, s in PARAM_SHAPES.items()}
             for scale in (2.0, 0.05, 1.5)]
    schedule = optim.warmup_cosine_schedule(1e-2, 1, 10)
    kwargs = dict(weight_decay=0.01, grad_clip=1.0)
    if grouped:
        def group(name):
            return "enc" if name.startswith("enc") else ("frozen" if name.startswith("frozen")
                                                         else "default")
        jax_kwargs = dict(param_groups=lambda path, v: group(path[0]), group_lrs={"enc": 3e-3},
                          frozen_groups=("frozen",))
        port_kwargs = dict(param_groups=lambda name, p: group(name), group_lrs={"enc": 3e-3},
                           frozen_groups=("frozen",))
    else:
        jax_kwargs = port_kwargs = {}

    tx = jax_optim.make_optimizer(jax_optim.warmup_cosine_schedule(1e-2, 1, 10), **kwargs,
                                  **jax_kwargs)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    opt = optim.make_optimizer(module, schedule, **kwargs, **port_kwargs)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step()
        want_norm = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2)) for v in g.values()))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
    assert opt.count == 3
    atol = 1e-4 * sum(schedule(k) for k in range(len(grads)))  # module docstring
    for k, p in module.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=atol, err_msg=k)
        assert not np.array_equal(p.detach().numpy(), params[k]) or (grouped and k == "frozen_w")
    if grouped:
        np.testing.assert_array_equal(module["frozen_w"].detach().numpy(), params["frozen_w"])


def test_optimizer_state_round_trips():
    module = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.ones(3))})
    opt = optim.make_optimizer(module, 1e-2)
    module["w"].grad = torch.full((3,), 0.5)
    opt.step()
    state = opt.state_dict()
    other = optim.make_optimizer(module, 1e-2)
    other.load_state_dict(state)
    assert other.count == 1
    torch.testing.assert_close(other.adamw.state_dict()["state"][0]["exp_avg"],
                               opt.adamw.state_dict()["state"][0]["exp_avg"])
