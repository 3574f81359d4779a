"""ART's bf16 train step in the port against the JAX package, through the
fused attention's backward (K4's backward) and through the plain path.

The recipe is ``bench.py``'s flash train step, ``ArtifactRemovalTransformer(
ArtConfig(attn_dropout=0.0), dtype=bfloat16)``, at tests/test_torch_art_train.py's
tiny geometry (8 channels, T 256, embed 32, 1 + 1 layers, 4 heads: 3
attention calls a forward), without dropout, weights from
``art_state_dict_from_flax``.

Bounds.  bf16 rounds at every projection, so the gradients of a bf16 step
sit at the bf16-vs-f32 level however the attention is computed (JAX's own
bf16 step is up to 0.019 of a tensor's largest |entry| from its f32 step
here): each gradient tensor is held within 2**-5 of its largest |entry|, the
share tests/test_torch_art.py holds the bf16 forward's output to; the key
projections' biases, zero in exact arithmetic, within 2**-5 of the largest
gradient.  The loss within 2**-8 relative, one bf16 rounding.

- The step on the CPU (the plain attention path) against
  ``jax.value_and_grad`` of the JAX bf16 model.
- The same step with ``attention_route`` sending the calls through the
  autograd Functions (as the route does on the card, where they run K3's
  bf16 forward and K4's backward kernels; here their twins): within the
  bounds of the plain path's, one backward call per attention call, no call
  of the stock backward in bf16; an optimizer step leaves the f32
  parameters f32.
- A bf16 ``MultiHeadAttention`` with d_k 128 (d_model 256, 2 heads, T 128)
  forced onto the flash route against the JAX ``MultiHeadAttention``'s
  gradients, which on the CPU take its einsum path, the same function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.art import art_loss as jax_art_loss
from eyegaze_tpu.models.transformer import MultiHeadAttention as JaxMHA
from eyegaze_tpu_torch import train_art
from eyegaze_tpu_torch.kernels import attention
from eyegaze_tpu_torch.models import transformer
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.convert import art_state_dict_from_flax
from eyegaze_tpu_torch.models.transformer import MultiHeadAttention
from eyegaze_tpu_torch.train.optim import make_optimizer

CPU = torch.device("cpu")
C, T, B = 8, 256, 4
TINY = dict(in_channels=C, out_channels=C, embedding_size=32, num_encoder_layers=1,
            num_decoder_layers=1, num_heads=4, feedforward_size=64, max_len=T)
CALLS = 3  # encoder self, decoder self and cross attention
SHARE = 2.0 ** -5
LOSS_RTOL = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_params():
    z = jnp.zeros((1, C, T), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(JaxArt(JaxArtConfig(**TINY)).init)(
        jax.random.PRNGKey(0), z, z)["params"])


@pytest.fixture(scope="module")
def batch():
    return train_art.build_dataset(B, C, T, seed=3).arrays


def _port(params):
    model = ArtifactRemovalTransformer(ArtConfig(**TINY, attn_dropout=0.0), device=CPU,
                                       dtype=torch.bfloat16,
                                       generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           art_state_dict_from_flax(params).items()}, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model.train()


def _grads(model, batch):
    loss_fn, _ = train_art.make_objective(False)
    loss, _ = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.item(), {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _assert_grads_close(got: dict, want: dict, zero=("k_proj.bias",)):
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        assert g.dtype == np.float32, k
        atol = SHARE * (largest if k.endswith(zero) else np.abs(want[k]).max())
        np.testing.assert_allclose(g, want[k], rtol=0, atol=atol, err_msg=k)


def _through_the_functions(monkeypatch, route: str) -> None:
    def kernel_route(*args, has_mask, dropout_active, return_weights):
        return "plain" if has_mask or dropout_active or return_weights else route

    monkeypatch.setattr(transformer, "attention_route", kernel_route)


def test_bf16_step_matches_jax(tiny_params, batch):
    jm = JaxArt(JaxArtConfig(**TINY, attn_dropout=0.0), dtype=jnp.bfloat16)

    def jax_loss(params):
        recon = jm.apply({"params": params}, jnp.asarray(batch["input_values"]),
                         jnp.asarray(batch["labels"]), deterministic=True)
        return jax_art_loss(recon, jnp.asarray(batch["labels"]))

    want_loss, grads = jax.jit(jax.value_and_grad(jax_loss))(tiny_params)
    want = art_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    loss, got = _grads(_port(tiny_params), batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    _assert_grads_close(got, want)


def test_bf16_step_through_the_functions_matches_the_plain_path(tiny_params, batch,
                                                                 monkeypatch):
    want_loss, want = _grads(_port(tiny_params), batch)
    _through_the_functions(monkeypatch, "headpacked")
    before = (dict(attention.backward_count), dict(attention.stock_backward_count))
    model = _port(tiny_params)
    loss, got = _grads(model, batch)
    assert attention.backward_count == {
        **before[0], "headpacked_attention": before[0]["headpacked_attention"] + CALLS}
    assert attention.stock_backward_count == before[1]
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(got, want)
    opt = make_optimizer(model, 1e-4, 0.01, grad_clip=1.0)
    opt.step()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())


def test_bf16_flash_route_mha_matches_jax(monkeypatch):
    """d_model 256, 2 heads (d_k 128), T 128: the input's and every
    parameter's gradient of sum(out * g)."""
    r = np.random.default_rng(14)
    x = r.normal(size=(2, 128, 256)).astype(np.float32)
    g = r.normal(size=(2, 128, 256)).astype(np.float32)
    jm = JaxMHA(256, 2, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x, x, x)["params"])

    def jax_loss(p, xb):
        out = jm.apply({"params": p}, xb, xb, xb).astype(jnp.float32)
        return jnp.sum(out * jnp.asarray(g))

    want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = MultiHeadAttention(256, 2, device=CPU, dtype=torch.bfloat16)
    tm.load_state_dict({f"{n}.{p}": torch.tensor(params[n]["kernel"].T if p == "weight"
                                                 else params[n]["bias"])
                        for n in ("q_proj", "k_proj", "v_proj", "out_proj")
                        for p in ("weight", "bias")}, strict=True)
    _through_the_functions(monkeypatch, "flash")
    before = attention.backward_count["flash_attention"]
    xt = torch.from_numpy(x).requires_grad_()
    (tm(xt, xt, xt).float() * torch.from_numpy(g)).sum().backward()
    assert attention.backward_count["flash_attention"] == before + 1
    got = {f"{n}.{p}": getattr(getattr(tm, n), p).grad.numpy() for n in params
           for p in ("weight", "bias")}
    want = {f"{n}.{p}": np.asarray(want_p[n]["kernel"]).T if p == "weight"
            else np.asarray(want_p[n]["bias"]) for n in params for p in ("weight", "bias")}
    _assert_grads_close({**got, "x": xt.grad.numpy()}, {**want, "x": np.asarray(want_x)})
