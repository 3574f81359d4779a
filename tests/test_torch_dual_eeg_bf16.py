"""The port's DualEEGTransformer in bf16 compute against Flax's
``DualEEGTransformer(dtype=jnp.bfloat16)``, the model the JAX
``Predictor.from_checkpoint`` serves.

At the small geometry of tests/test_torch_dual_eeg.py (C = 8, d_model 32,
2 layers) with T = 256, from the same converted weights:

- end to end, for the robust, legacy, no-spectrogram and
  no-cross-attention configurations, every output within ``2**-5`` of its
  largest value; and over all outputs together, the port's largest gap to
  Flax bf16 below Flax f32's largest gap to Flax bf16, so the port is
  closer to the bf16 model than the f32 model is;
- block by block, each block fed the eager JAX model's own input to it
  (frontend, spectrogram generator, both IBS tokenizers, encoder,
  cross-attention, the fusion and classifier heads), within ``2**-7`` of
  its largest output.

The JAX references run eagerly (``model.apply`` without ``jax.jit``), so
every bf16 rounding the Flax modules write happens; under jit XLA may keep
a fused bf16 intermediate in float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.dual_eeg import DualEEGTransformer as JaxDualEEG
from eyegaze_tpu.ops.connectivity import connectivity_matrices as jax_connectivity_matrices
from eyegaze_tpu.ops.spectral import BAND_DEFS_6
from eyegaze_tpu_torch.models.convert import dual_eeg_state_dict_from_flax
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer

C, T = 8, 256
GEOMETRY = dict(in_channels=C, num_classes=3, d_model=32, num_layers=2, num_heads=4, d_ff=64,
                max_len=128, conv_kernel_size=7, conv_stride=4, conv_layers=2,
                sampling_rate=256.0)
CONFIGS = {
    "robust": {},
    "legacy_ibs": dict(use_robust_ibs=False),
    "no_spectrogram": dict(use_spectrogram=False),
    "no_cross_attention": dict(use_cross_attention=False),
}
END_TO_END_SHARE = 2.0 ** -5
BLOCK_SHARE = 2.0 ** -7
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(flags):
    """(Flax f32, Flax bf16, their params, port bf16, port f32), one weights."""
    j32 = JaxDualEEG(**GEOMETRY, **flags)
    j16 = JaxDualEEG(**GEOMETRY, **flags, dtype=jnp.bfloat16)
    z = jnp.zeros((1, C, T), jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(j32.init)(jax.random.PRNGKey(0), z, z)["params"])
    state = {k: torch.tensor(v) for k, v in dual_eeg_state_dict_from_flax(params).items()}
    ports = []
    for dtype in (torch.bfloat16, torch.float32):
        tm = DualEEGTransformer(**GEOMETRY, **flags, device=CPU, dtype=dtype,
                                generator=torch.Generator().manual_seed(1))
        tm.load_state_dict(state, strict=True)
        ports.append(tm.eval())
    return j32, j16, params, *ports


def _pair(seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=(3, C, T)).astype(np.float32) for _ in range(2)]


def _torch_of(a) -> torch.Tensor:
    """A bf16 or f32 JAX array as the torch tensor of the same type, exactly."""
    a = np.asarray(a)
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("config", list(CONFIGS))
def test_bf16_forward_matches_flax_bf16(config):
    j32, j16, params, tm, _ = _models(CONFIGS[config])
    e1, e2 = _pair(7)
    want = j16.apply({"params": params}, e1, e2)
    f32 = j32.apply({"params": params}, e1, e2)
    with torch.inference_mode():
        got = tm(torch.from_numpy(e1), torch.from_numpy(e2))
    assert set(got) == set(want)
    port_gap = f32_gap = 0.0
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float32 and w.dtype == np.float32, k
        g = got[k].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=END_TO_END_SHARE * np.abs(w).max(),
                                   err_msg=k)
        port_gap = max(port_gap, float(np.abs(g - w).max()))
        f32_gap = max(f32_gap, float(np.abs(np.asarray(f32[k]) - w).max()))
    assert port_gap < f32_gap, (port_gap, f32_gap)


@pytest.mark.parametrize("config", ["robust", "legacy_ibs"])
def test_bf16_blocks_round_where_flax_rounds(config):
    """Each block, fed the eager Flax bf16 model's own input, lands within
    ``2**-7`` of its largest output, and closer to Flax bf16 than the port's
    f32 model on the same input is, on average: bf16 compute is in effect."""
    _, j16, params, tm16, tm32 = _models(CONFIGS[config])
    e1, e2 = _pair(8)
    out, state = j16.apply({"params": params}, e1, e2, capture_intermediates=True,
                           mutable=["intermediates"])
    seen = state["intermediates"]

    def calls(name):
        return seen[name]["__call__"]

    x1, x2 = torch.from_numpy(e1), torch.from_numpy(e2)
    z1, z2 = (_torch_of(z) for z in calls("encoder"))
    c1, c2 = (_torch_of(z) for z in calls("cross_attn")[0])
    blocks = {
        "temporal_conv": (lambda m: m.temporal_conv(x1), calls("temporal_conv")[0]),
        "spectrogram_generator": (lambda m: m.spectrogram_generator(x1),
                                  calls("spectrogram_generator")[0]),
        "encoder": (lambda m: m.encoder(_torch_of(calls("pos_embed")[0])), calls("encoder")[0]),
        "cross_attn": (lambda m: m.cross_attn(z1, z2)[0], calls("cross_attn")[0][0]),
        "heads, logits": (lambda m: m.heads(c1, c2)["logits"], out["logits"]),
        "heads, ibs_logits": (lambda m: m.heads(c1, c2)["ibs_logits"], out["ibs_logits"]),
    }
    if config == "robust":
        matrices = _torch_of(jax_connectivity_matrices(e1, e2, 256.0, BAND_DEFS_6))
        blocks["ibs_tokenizer"] = (lambda m: m.ibs_tokenizer(matrices), calls("ibs_tokenizer")[0])
    else:
        blocks["ibs_generator"] = (lambda m: m.ibs_generator(x1, x2), calls("ibs_generator")[0])
    for name, (run, want) in blocks.items():
        want = np.asarray(want).astype(np.float32)
        with torch.inference_mode():
            got16, got32 = (run(m).float().numpy() for m in (tm16, tm32))
        np.testing.assert_allclose(got16, want, rtol=0, atol=BLOCK_SHARE * np.abs(want).max(),
                                   err_msg=name)
        assert np.abs(got16 - want).mean() < np.abs(got32 - want).mean(), name


def test_bf16_state_dict_and_compute_types():
    """One f32 state_dict loads strictly into both compute types; parameters
    stay f32, the buffers stay out of the state_dict, and any other compute
    type is refused."""
    _, _, _, tm16, tm32 = _models({})
    assert tm16.dtype == torch.bfloat16 and tm32.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm16.parameters())
    assert set(tm16.state_dict()) == set(tm32.state_dict())
    assert "spectrogram_generator.window" not in tm16.state_dict()
    with torch.inference_mode():
        h = tm16.temporal_conv(torch.zeros(1, C, T))
        s = tm16.spectrogram_generator(torch.zeros(1, C, T))
    assert h.dtype == s.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        DualEEGTransformer(**GEOMETRY, device=CPU, dtype=torch.float16,
                           generator=torch.Generator())
