"""The PyTorch port's ART denoiser and its serving against the JAX package.

At a small geometry (8 channels, embed 32, 2 + 2 layers, 4 heads, ff 64,
T = 256): JAX parameters from ``model.init`` are converted with
``art_state_dict_from_flax``, loaded with ``strict=True``, and both forwards
must agree at 1e-4, the tolerance of tests/test_torch_port.py's ART parity
(f32 on both sides; sums in another order through 4 post-LN blocks).

bf16 compute (T = 128) against the Flax model built with ``dtype=bf16``,
from the same converted weights: end to end within ``2**-5`` of the largest
output (see ``test_bf16_forward_matches_jax``), and block by block, each fed
the JAX model's own input, far closer to JAX than to the f32 port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models.art import ArtConfig as JaxArtConfig
from eyegaze_tpu.models.art import ArtifactRemovalTransformer as JaxArt
from eyegaze_tpu.models.torch_port import export_art_state_dict
from eyegaze_tpu.serving import ArtDenoiser as JaxArtDenoiser
from eyegaze_tpu_torch.kernels import attention
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.convert import art_state_dict_from_flax
from eyegaze_tpu_torch.serving import ArtDenoiser

C, T = 8, 256
GEOMETRY = dict(in_channels=C, out_channels=C, embedding_size=32, num_encoder_layers=2,
                num_decoder_layers=2, num_heads=4, feedforward_size=64, max_len=T)
TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """JAX parameters per position mode; the head's options add none."""
    z = jnp.zeros((1, C, T), jnp.float32)
    return {mode: jax.tree_util.tree_map(
        np.asarray, jax.jit(JaxArt(JaxArtConfig(**GEOMETRY, pos_mode=mode)).init)(
            jax.random.PRNGKey(0), z)["params"])
        for mode in ("sinusoidal", "learned")}


def _pair(params, **options):
    """(JAX model, its params, port model loaded with the same weights)."""
    options.setdefault("pos_mode", "sinusoidal")
    p = params[options["pos_mode"]]
    tm = ArtifactRemovalTransformer(ArtConfig(**GEOMETRY, **options), device=CPU,
                                    generator=torch.Generator().manual_seed(1))
    tm.load_state_dict({k: torch.tensor(v) for k, v in art_state_dict_from_flax(p).items()},
                       strict=True)
    return JaxArt(JaxArtConfig(**GEOMETRY, **options)), p, tm.eval()


def _noisy(n, seed, t=T):
    return np.random.default_rng(seed).normal(size=(n, C, t)).astype(np.float32)


@pytest.mark.parametrize("mode", ["sinusoidal", "learned"])
def test_state_dict_matches_reference_exporter_and_loads_strictly(params, mode):
    got = art_state_dict_from_flax(params[mode])
    want = export_art_state_dict(params[mode])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["src_embed.0.conv.weight"].shape == (32, C, 1)
    _, _, tm = _pair(params, pos_mode=mode)  # strict load inside
    assert ("src_embed.1.pos_embed.weight" in tm.state_dict()) == (mode == "learned")
    assert not any(k.endswith(".pe") for k in tm.state_dict())


OPTIONS = {
    "sinusoidal": dict(),
    "learned": dict(pos_mode="learned"),
    "zscore_batch": dict(recon_zscore="batch"),
    "zscore_time": dict(recon_zscore="time"),
    "log_softmax": dict(recon_log_softmax=True),
    "log_softmax_zscore_time_learned": dict(recon_log_softmax=True, recon_zscore="time",
                                            pos_mode="learned"),
}


@pytest.mark.parametrize("case", list(OPTIONS))
def test_forward_matches_jax(params, case):
    jm, p, tm = _pair(params, **OPTIONS[case])
    src = _noisy(3, seed=2)
    tgt = _noisy(3, seed=3)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, src, tgt))
    with torch.inference_mode():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert got.shape == (3, C, T) and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-2  # non-degenerate fixture
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_masked_forward_matches_jax(params):
    """src_mask (B, T) and a (B, T, T) tgt_mask, True = masked out, with the
    JAX package's inversion; without tgt the decoder reads src."""
    jm, p, tm = _pair(params)
    src = _noisy(2, seed=4)
    r = np.random.default_rng(5)
    src_mask = r.random((2, T)) < 0.25
    tgt_mask = np.triu(np.ones((T, T), bool), k=1)[None].repeat(2, axis=0)  # causal
    want = np.asarray(jax.jit(jm.apply)({"params": p}, src, None, src_mask, tgt_mask))
    with torch.inference_mode():
        got = tm(torch.from_numpy(src), None, torch.from_numpy(src_mask),
                 torch.from_numpy(tgt_mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with torch.inference_mode():
        unmasked = tm(torch.from_numpy(src)).numpy()
    assert np.abs(unmasked - got).max() > 1e-2  # the masks took effect


@pytest.mark.parametrize("zscore", [None, "batch"])
def test_denoiser_matches_jax(params, zscore):
    """Buckets (2, 4): 3 windows pad to 4, 9 run as chunks of 4, 4 and 1 -> 2.
    With the batch z-score both sides serve one sample at a time."""
    jm, p, tm = _pair(params, recon_zscore=zscore)
    jden = JaxArtDenoiser(jm, p, batch_buckets=(2, 4))
    den = ArtDenoiser(tm, device=CPU, batch_buckets=(2, 4))
    assert den.buckets == jden.buckets == ((1,) if zscore == "batch" else (2, 4))
    den.warmup()
    noisy = _noisy(9, seed=6)
    before = dict(attention.launch_count)
    for n in (3, 9):
        want = jden.predict(noisy[:n])["denoised"]
        got = den.predict(noisy[:n])["denoised"]
        assert got.shape == (n, C, T) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert attention.launch_count == before  # the CPU path never launches the kernel
    if zscore == "batch":  # per sample: a row's output ignores the other rows
        np.testing.assert_allclose(den.predict(noisy[1:2])["denoised"][0], got[1],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_denoiser_serves_float64_as_float32(dtype):
    """A float64 numpy request is served as float32 in either compute type:
    its output is that of the same request given as float32."""
    tm = ArtifactRemovalTransformer(ArtConfig(**GEOMETRY), device=CPU,
                                    dtype=getattr(torch, dtype),
                                    generator=torch.Generator().manual_seed(2))
    den = ArtDenoiser(tm, device=CPU, batch_buckets=(2, 4))
    noisy = np.random.default_rng(7).normal(size=(3, C, T))
    assert noisy.dtype == np.float64
    got = den.predict(noisy)["denoised"]
    assert got.dtype == np.float32 and got.shape == (3, C, T)
    np.testing.assert_array_equal(got, den.predict(noisy.astype(np.float32))["denoised"])



# bf16 compute: ART's 2 + 2 layers, embed 32, 4 heads, T = 128.
BF16_T = 128
# End to end, a share of the largest output: 8 bf16 steps there.  JAX and
# the port round at the same places (test_bf16_blocks_round_where_jax_rounds)
# but sum in another order, and under jit XLA may keep a fused intermediate
# in f32, so single bf16 roundings flip; each post-LN block spreads a flip
# over its row, and 4 blocks take the gap to a few output steps (measured
# 2**-6.9 and 2**-6.2 of the largest output here, and 2**-6.4 at
# ArtConfig()'s full width and T = 1024).
BF16_TOL_SHARE = 2.0 ** -5


def _bf16_pair(params, **options):
    """(JAX bf16 model, its params, port bf16 model, port f32 model), the
    port's two from one converted f32 state_dict."""
    cfg = dict(GEOMETRY, max_len=BF16_T, **options)
    p = params["sinusoidal"]
    state = {k: torch.tensor(v) for k, v in art_state_dict_from_flax(p).items()}
    ports = []
    for dtype in (torch.bfloat16, torch.float32):
        tm = ArtifactRemovalTransformer(ArtConfig(**cfg), device=CPU, dtype=dtype,
                                        generator=torch.Generator().manual_seed(1))
        tm.load_state_dict(state, strict=True)
        ports.append(tm.eval())
    return JaxArt(JaxArtConfig(**cfg), dtype=jnp.bfloat16), p, *ports


@pytest.mark.parametrize("mode", ["sinusoidal", "learned"])
def test_one_state_dict_loads_into_both_dtypes(params, mode):
    """The f32 state_dict of the converter loads strictly into a model of
    either compute type; the parameters stay f32 (Flax keeps them so) and
    come back unchanged."""
    state = {k: torch.tensor(v) for k, v in art_state_dict_from_flax(params[mode]).items()}
    for dtype in (torch.float32, torch.bfloat16):
        tm = ArtifactRemovalTransformer(ArtConfig(**GEOMETRY, pos_mode=mode), device=CPU,
                                        dtype=dtype, generator=torch.Generator().manual_seed(1))
        tm.load_state_dict(state, strict=True)
        assert tm.dtype == dtype
        assert all(p.dtype == torch.float32 for p in tm.parameters())
        got = tm.state_dict()
        assert set(got) == set(state)
        for k in state:
            torch.testing.assert_close(got[k], state[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ArtifactRemovalTransformer(ArtConfig(**GEOMETRY), device=CPU, dtype=torch.float16,
                                   generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("zscore", [None, "time"])
def test_bf16_forward_matches_jax(params, zscore):
    jm, p, tm, _ = _bf16_pair(params, recon_zscore=zscore)
    src, tgt = _noisy(3, seed=2, t=BF16_T), _noisy(3, seed=3, t=BF16_T)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, src, tgt))
    with torch.inference_mode():
        got = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert got.shape == (3, C, BF16_T) and got.dtype == torch.float32
    assert np.abs(want).max() > 1e-1
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_TOL_SHARE * np.abs(want).max())


@pytest.mark.parametrize("zscore", [None, "time"])
def test_bf16_blocks_round_where_jax_rounds(params, zscore):
    """Each encoder and decoder block and the head, fed the JAX bf16 model's
    own input to it: the port in bf16 is at least 10 times closer to JAX on
    average than the port in f32 is (measured 300-1000x; the head, z-score
    included, is bit-exact).  So the port rounds where JAX rounds (Dense
    outputs, P, the context, the head; LayerNorm and the residual stream
    after it in f32), and bf16 is in effect.  End to end the two are only as
    close as BF16_TOL_SHARE says: there a flipped rounding spreads."""
    jm, p, tm16, tm32 = _bf16_pair(params, recon_zscore=zscore)
    src, tgt = _noisy(3, seed=2, t=BF16_T), _noisy(3, seed=3, t=BF16_T)
    # Eager, op by op, so every bf16 rounding the modules write happens: under
    # jit, XLA's default excess precision may keep a fused intermediate in
    # f32 (the jitted and the eager JAX model differ by as much as the
    # port differs from either, end to end).
    _, state = jm.apply({"params": p}, src, tgt, capture_intermediates=True,
                        mutable=["intermediates"])
    seen = state["intermediates"]

    def out(*path):
        node = seen
        for key in path:
            node = node[key]
        return node["__call__"][0]

    def torch_of(a):  # a bf16 or f32 JAX array, exactly
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)

    blocks = []
    for i in range(GEOMETRY["num_encoder_layers"]):
        x = out("src_pos") if i == 0 else out("encoder", f"layer_{i - 1}")
        blocks.append((lambda m, x=x, i=i: m.encoder.layers[i](torch_of(x)),
                       out("encoder", f"layer_{i}")))
    for i in range(GEOMETRY["num_decoder_layers"]):
        x = out("tgt_pos") if i == 0 else out("decoder", f"layer_{i - 1}")
        blocks.append((lambda m, x=x, i=i: m.decoder.layers[i](torch_of(x),
                                                              torch_of(out("encoder"))),
                       out("decoder", f"layer_{i}")))
    blocks.append((lambda m: m.reconstructor(torch_of(out("decoder"))), out("reconstructor")))
    for run, want in blocks:
        want = np.asarray(want).astype(np.float32)
        with torch.inference_mode():
            got16, got32 = (run(m).float().numpy() for m in (tm16, tm32))
        to_jax = np.abs(got16 - want).mean()
        rounding = np.abs(got16 - got32).mean()
        assert rounding > 1e-3  # bf16 compute is in effect
        assert to_jax * 10 <= rounding, (to_jax, rounding)


@pytest.mark.parametrize("zscore", [None, "time"])
def test_bf16_denoiser_matches_jax(params, zscore):
    """bf16 models behind both denoisers, buckets (2, 4): f32 numpy in, f32
    out, the end-to-end bound of test_bf16_forward_matches_jax."""
    jm, p, tm, _ = _bf16_pair(params, recon_zscore=zscore)
    jden = JaxArtDenoiser(jm, p, batch_buckets=(2, 4))
    den = ArtDenoiser(tm, device=CPU, batch_buckets=(2, 4))
    den.warmup()
    noisy = _noisy(5, seed=6, t=BF16_T)
    before = dict(attention.launch_count)
    want = jden.predict(noisy)["denoised"]
    got = den.predict(noisy)["denoised"]  # chunks of 4 and 1, padded to 2
    assert got.shape == (5, C, BF16_T) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL_SHARE * np.abs(want).max())
    assert attention.launch_count == before
