"""HyperEEG in the port against the JAX package, and its serving.

- Every ablation in float32 at in_channels 8, embed 32, 4 heads, sinc
  kernel 33 on T = 333 (odd, not a multiple of 64, so both strided convs
  pad unevenly), JAX's parameters through
  ``convert.hypereeg_state_dict_from_flax`` (loaded with ``strict=True``):
  logits and fused within 1e-5 of each one's largest |value| (the same
  float32 math in other orders; seen 4.4e-7).
- The bf16 model ('full' and 'no_sinc', the plain conv in bf16) against
  Flax's bf16 model (``dtype=jnp.bfloat16``, eager), within 2**-5 of the
  largest |value| (the repo's bf16 bound; seen 6.4e-3).
- The bf16 blocks (temporal, graph, cross, fusion) fed the eager Flax bf16
  model's own inputs: within 2**-8 of the largest |value|, and on average
  a tenth of the gap a float32 block leaves or less (seen 2e-3 to 0.04 of
  it).  A softmax in float32, an ``exp(logvar)`` in float32 or a LayerNorm
  that returns its input's type instead of float32 fails it.
- ``same_pad`` + the strided conv against Flax's ``padding="SAME"`` conv at
  T = 1024, 333, 128 and 17, within 1e-5.
- Parameter counts: 274,819 (documented) and 671,459 ('680k').

Serving is in tests/test_torch_hypereeg_serving.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from eyegaze_tpu.models import hypereeg as jax_hypereeg
from eyegaze_tpu_torch.models import convert, hypereeg
from eyegaze_tpu_torch.models.transformer import Conv1d

CPU = torch.device("cpu")
SMALL = dict(in_channels=8, embed_dim=32, num_heads=4, sinc_kernel_size=33)
F32_SHARE = 1e-5
SHARE = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(n, t, seed, c=8):
    r = np.random.default_rng(seed)
    return [r.normal(size=(n, c, t)).astype(np.float32) for _ in range(2)]


def _jax_params(ablation, e1, e2, **geometry):
    jm = jax_hypereeg.create_hypereeg_model(ablation, **geometry)
    # Eager, as the apply: the ablations share their primitives' compiles.
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), e1, e2)["params"])


def _port(ablation, params, dtype=torch.float32, **geometry):
    model = hypereeg.create_hypereeg_model(ablation, **geometry, device=CPU, dtype=dtype,
                                           generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           convert.hypereeg_state_dict_from_flax(params).items()}, strict=True)
    return model.eval()


def _check(got, want, share):
    assert set(got) == set(want) == {"logits", "fused"}
    for k in got:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=share * float(np.abs(w).max()), err_msg=k)


@pytest.mark.parametrize("ablation", list(hypereeg.ABLATIONS))
def test_every_ablation_matches_jax_in_float32(ablation):
    assert hypereeg.ABLATIONS == jax_hypereeg.ABLATIONS
    e1, e2 = _pairs(3, 333, 0)
    params = _jax_params(ablation, e1, e2, **SMALL)
    want = jax_hypereeg.create_hypereeg_model(ablation, **SMALL).apply({"params": params}, e1, e2)
    with torch.no_grad():
        got = _port(ablation, params, **SMALL)(torch.from_numpy(e1), torch.from_numpy(e2))
    _check(got, want, F32_SHARE)


@pytest.mark.parametrize("ablation", ["full", "no_sinc"])
def test_bf16_matches_the_flax_bf16_model(ablation):
    e1, e2 = _pairs(3, 256, 1)
    params = _jax_params(ablation, e1, e2, **SMALL)
    want = jax_hypereeg.create_hypereeg_model(ablation, **SMALL, dtype=jnp.bfloat16).apply(
        {"params": params}, e1, e2)
    with torch.no_grad():
        got = _port(ablation, params, torch.bfloat16, **SMALL)(torch.from_numpy(e1),
                                                               torch.from_numpy(e2))
    _check(got, want, SHARE)


@pytest.mark.parametrize("t", [1024, 333, 128, 17])
@pytest.mark.parametrize("kernel,stride", [(15, 8), (9, 8), (33, 1)])
def test_same_padding_matches_flax(t, kernel, stride):
    x = np.random.default_rng(t).normal(size=(2, t, 3)).astype(np.float32)  # Flax's (N, T, C)
    conv = fnn.Conv(4, (kernel,), strides=(stride,), padding="SAME")
    params = conv.init(jax.random.PRNGKey(0), x)["params"]
    want = np.asarray(conv.apply({"params": params}, x))
    port = Conv1d(3, 4, kernel, stride=stride, device=CPU)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.moveaxis(np.asarray(params["kernel"]), (2, 1),
                                                       (0, 1))))
        port.bias.copy_(torch.from_numpy(np.asarray(params["bias"])))
        got = port(hypereeg.same_pad(torch.from_numpy(x).transpose(1, 2), kernel, stride))
    assert got.shape[-1] == -(-t // stride)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=0, atol=1e-5)


def test_parameter_counts_of_the_presets():
    counts = {}
    for preset in hypereeg.PRESETS:
        model = hypereeg.create_hypereeg_model("full", preset, device=CPU,
                                               generator=torch.Generator().manual_seed(0))
        counts[preset] = sum(p.numel() for p in model.parameters())
    assert counts == {"documented": 274_819, "680k": 671_459}
    assert hypereeg.PRESETS == jax_hypereeg.PRESETS
    with pytest.raises(ValueError, match="ablation"):
        hypereeg.create_hypereeg_model("none", device=CPU, generator=torch.Generator())


@pytest.mark.parametrize("ablation", ["full", "no_sinc"])
def test_bf16_blocks_round_where_flax_rounds(ablation):
    e1, e2 = _pairs(2, 256, 4)
    params = _jax_params(ablation, e1, e2, **SMALL)
    port = {dtype: _port(ablation, params, dtype, **SMALL)
            for dtype in (torch.bfloat16, torch.float32)}
    _, seen = jax_hypereeg.create_hypereeg_model(ablation, **SMALL, dtype=jnp.bfloat16).apply(
        {"params": params}, e1, e2, capture_intermediates=True, mutable=["intermediates"])
    seen = seen["intermediates"]

    def out(name, call=0):
        return np.array(jnp.asarray(seen[name]["__call__"][call]).astype(jnp.float32))

    temporal, graph = [out("temporal", i) for i in (0, 1)], [out("graph", i) for i in (0, 1)]
    cross = [np.array(z.astype(jnp.float32)) for z in seen["cross"]["__call__"][0]]
    blocks = [(f"temporal_{i}", lambda m, x=x: m.temporal(torch.from_numpy(x)), temporal[i])
              for i, x in enumerate((e1, e2))]
    blocks += [(f"graph_{i}", lambda m, x=temporal[i]: m.graph(torch.from_numpy(x).to(m.dtype)),
                graph[i]) for i in (0, 1)]
    blocks.append(("cross", lambda m: torch.cat(m.cross(*map(torch.from_numpy, graph))),
                   np.concatenate(cross)))
    blocks.append(("fusion", lambda m: m.fusion(*map(torch.from_numpy, cross)), out("fusion")))
    with torch.inference_mode():
        for name, run, want in blocks:
            got16, got32 = (run(port[d]).float().numpy() for d in (torch.bfloat16, torch.float32))
            np.testing.assert_allclose(got16, want, rtol=0,
                                       atol=2.0 ** -8 * np.abs(want).max(), err_msg=name)
            gap16, gap32 = np.abs(got16 - want).mean(), np.abs(got32 - want).mean()
            assert gap16 <= gap32 / 10, (name, gap16, gap32)
