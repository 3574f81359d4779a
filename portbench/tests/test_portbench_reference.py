"""The program against the frozen plain reference, in float32 on the CPU.

Both sides compute in float32 here, so they differ only in the order of
their sums: matrix products blocked differently, the connectivity's pairwise
sums (K1's plain twin against the reference's broadcast), PLV as four real
products against one complex one.  That is about 1e-6 of an output's scale,
grown through the post-LN blocks; each tolerance below leaves a factor of
ten or more above what these sizes read.
"""

from __future__ import annotations

import pytest
import torch

from portbench import weights
from portbench.reference import dual_eeg as ref_dual
from portbench.reference import art as ref_art
from portbench.reference.optim import AdamW
from portbench.tests.conftest import small_setup

CPU = torch.device("cpu")
# Largest output gap over the output's largest magnitude, float32 against
# float32 (module docstring).
FORWARD_TOL = 1e-4


def _setup(family):
    setup = small_setup(family, "train", dtype="float32")
    cfg, fam = setup["config"], setup["family"]
    params = weights.make_params(fam.shapes(cfg), 11, CPU)
    model = fam.program_model(cfg, setup["mix"], CPU)
    model.load_state_dict(params, strict=True)
    gen = torch.Generator().manual_seed(5)
    return setup, cfg, fam, params, model, fam.train_batch(gen, cfg, 6)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_shapes_are_the_programs_state_dict():
    for family in ("dual_eeg", "art"):
        setup, cfg, fam, params, model, _ = _setup(family)
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in params.items()}


def test_flagship_forward_matches():
    _, cfg, _, params, model, batch = _setup("dual_eeg")
    model.eval()
    with torch.no_grad():
        got = model(batch["eeg1"], batch["eeg2"])
        want = ref_dual.forward(params, cfg, batch["eeg1"], batch["eeg2"])
    for key in ("logits", "cls1", "cls2", "ibs_logits", "ibs_token"):
        assert _rel(got[key], want[key]) < FORWARD_TOL, key


def test_flagship_connectivity_matches_the_programs():
    from eyegaze_tpu_torch.ops.connectivity import connectivity_matrices

    gen = torch.Generator().manual_seed(3)
    x1, x2 = weights.eeg(gen, 3, 8, 256, 256.0), weights.eeg(gen, 3, 8, 256, 256.0)
    got = connectivity_matrices(x1, x2, 256.0)
    want = ref_dual.connectivity(x1, x2, 256.0)
    # Values in [0, 1] (correlations in [-1, 1]); float32 sums of 256 terms.
    assert float((got - want).abs().max()) < 1e-4


def test_flagship_serving_matches():
    setup = small_setup("dual_eeg", "serve", dtype="float32")
    cfg, fam = setup["config"], setup["family"]
    params = weights.make_params(fam.shapes(cfg), 12, CPU)
    model = fam.program_model(cfg, {}, CPU)
    model.load_state_dict(params, strict=True)
    pred = fam.predictor(model, setup["mix"], CPU)
    x1, x2 = fam.requests(torch.Generator().manual_seed(4), cfg, 3)
    got = torch.as_tensor(fam.answer(pred.predict(x1.numpy(), x2.numpy())))
    with torch.no_grad():
        want = fam.reference_serve(params, cfg, (x1, x2), "exact")
    assert _rel(got, want) < FORWARD_TOL


def test_art_forward_and_serving_match():
    setup, cfg, fam, params, model, batch = _setup("art")
    model.eval()
    with torch.no_grad():
        got = model(batch["input_values"], batch["labels"])
        want = ref_art.forward(params, cfg, batch["input_values"], batch["labels"])
        assert _rel(got, want) < FORWARD_TOL
        pred = fam.predictor(model, {"buckets": [1, 8]}, CPU)
        served = torch.as_tensor(fam.answer(pred.predict(batch["input_values"].numpy())))
        assert _rel(served, ref_art.serve(params, cfg, batch["input_values"])) < FORWARD_TOL


@pytest.mark.parametrize("family", ["dual_eeg", "art"])
def test_loss_and_gradients_match(family):
    setup, cfg, fam, params, model, batch = _setup(family)
    model.train()
    loss, aux = fam.objective(cfg, setup["mix"])(model, batch)
    loss.backward()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want, terms = fam.reference_loss(p, cfg, batch, setup["mix"], "exact")
    grads = torch.autograd.grad(want, list(p.values()), allow_unused=True)
    # The loss: float32 sums of a few hundred terms.
    assert abs(float(loss.detach()) - float(want.detach())) < 1e-5 * abs(float(want.detach()))
    for k, v in terms.items():  # the flagship's five terms, as the program names them
        v = float(v.detach())
        assert abs(float(aux[k].detach()) - v) < 1e-5 * abs(v), k
    named = dict(model.named_parameters())
    scale = max(float(g.abs().max()) for g in grads if g is not None)
    for (name, _), g in zip(p.items(), grads):
        got = named[name].grad
        g = torch.zeros_like(got) if g is None else g
        # Gradients, against the largest gradient entry: the backward's
        # float32 sums in their own order.
        assert float((got - g).abs().max()) < 1e-4 * scale, name


def test_clip_and_adamw_match_the_programs_optimizer():
    from eyegaze_tpu_torch.train.optim import Optimizer

    gen = torch.Generator().manual_seed(9)
    start = {"a": torch.randn(5, 7, generator=gen), "b": torch.randn(3, generator=gen)}
    mod = torch.nn.Module()
    for k, v in start.items():
        mod.register_parameter(k, torch.nn.Parameter(v.clone()))
    prog = Optimizer(mod.named_parameters(), 1e-3, 0.01, grad_clip=1.0)
    ref_params = {k: v.clone() for k, v in start.items()}
    ref = AdamW(ref_params, 1e-3, 0.01, 1.0)
    for scale in (0.01, 10.0, 0.5):  # below, above and near the clip
        grads = {k: scale * torch.randn(v.shape, generator=gen) for k, v in start.items()}
        for k, p in mod.named_parameters():
            p.grad = grads[k].clone()
        prog.step()
        ref.step(grads)
    for k, p in mod.named_parameters():
        # Float32 AdamW in its own order of operations: a few ulps of the step.
        assert float((p.detach() - ref_params[k]).abs().max()) < 1e-6
