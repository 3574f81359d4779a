"""Attention kernel (K3, K4) of the PyTorch port against the JAX package.

The plain twin ``attention_reference`` is held to the Pallas head-packed
kernel in interpret mode (K3) and to the stock flash module's
``mha_reference`` (K4, its (B, H, T, d) layout), on the same numpy inputs.
``attention_route`` is checked gate by gate, and ``MultiHeadAttention`` with
masks and in bf16 against the JAX MHA.  The CUDA kernel itself runs only on
the card (``cuda`` marker); jax is imported inside the tests that compare
against it, so the card's tests run where jax is not installed:

    python -m pytest tests/test_torch_attention.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch.kernels import attention
from eyegaze_tpu_torch.models.transformer import MultiHeadAttention, attention_route

CPU = torch.device("cpu")
# A bf16 output holds 8 significant bits: one rounding of a value below 1 in
# magnitude moves it by at most 2**-9, two roundings (of P, then of the
# output) by 2**-8.
BF16_ATOL = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed=0, kv_len=None):
    r = np.random.default_rng(seed)
    kv_shape = list(shape)
    if kv_len is not None:
        kv_shape[1] = kv_len
    return (r.normal(size=shape).astype(np.float32),
            r.normal(size=kv_shape).astype(np.float32),
            r.normal(size=kv_shape).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_headpacked_twin_matches_pallas_interpret(dtype):
    """(2, 256, 8, 16), the shape of tests/test_flash_attn.py's kernel parity.

    f32: both sum the same products in another order, 1e-6.  bf16: P is
    rounded to bf16 on both sides; the outputs (|o| < 1) agree to
    ``BF16_ATOL``.  Scores rounded to bf16 before the softmax, the fault
    the port's MHA had, miss that by 4x at this shape.
    """
    import jax.numpy as jnp

    from eyegaze_tpu.ops.attn_kernels import headpacked_attention as jax_headpacked

    q, k, v = _qkv((2, 256, 8, 16), seed=1)
    scale = 1.0 / math.sqrt(16)
    want = np.asarray(jax_headpacked(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                                     scale, True).astype(jnp.float32))
    before = dict(attention.launch_count)
    got = attention.headpacked_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)), scale)
    assert attention.launch_count == before  # the CPU takes the twin
    assert got.shape == q.shape and got.dtype == getattr(torch, dtype)
    assert np.abs(want).max() < 1.0
    atol = 1e-6 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_flash_twin_matches_stock_mha_reference():
    """The (B, H, T, d) entry point against the stock module's own jnp
    reference, as tests/test_flash_attn.py pins the layout; f32, cross
    attention (Tq 256, Tk 128), d 128."""
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

    q, k, v = _qkv((2, 4, 256, 128), seed=2)
    k, v = k[:, :, :128], v[:, :, :128]
    scale = 1.0 / math.sqrt(128)
    want = np.asarray(mha_reference(*(jnp.asarray(a) for a in (q, k, v)), None, sm_scale=scale))
    got = attention.flash_attention(*(torch.from_numpy(np.ascontiguousarray(a))
                                      for a in (q, k, v)), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_both_entry_points_are_one_function_in_two_layouts():
    q, k, v = (torch.from_numpy(a) for a in _qkv((3, 200, 8, 16), seed=3, kv_len=130))
    scale = 0.25
    bthd = attention.headpacked_attention(q, k, v, scale)
    bhtd = attention.flash_attention(*(x.transpose(1, 2) for x in (q, k, v)), scale)
    torch.testing.assert_close(bthd, bhtd.transpose(1, 2), rtol=0, atol=0)


GATES = {  # name: (device, dtype, tq, tk, d_k, mask, dropout, weights) -> route
    "art_self_attention": (("cuda", torch.float32, 1024, 1024, 16, False, False, False),
                           "headpacked"),
    "art_bf16": (("cuda", torch.bfloat16, 1024, 1024, 16, False, False, False), "headpacked"),
    # ART's bf16 compute at its positional table's full length, and on the CPU.
    "art_bf16_max_len": (("cuda", torch.bfloat16, 2048, 2048, 16, False, False, False),
                         "headpacked"),
    "art_bf16_cpu": (("cpu", torch.bfloat16, 1024, 1024, 16, False, False, False), "plain"),
    "flagship_139_tokens": (("cuda", torch.float32, 139, 139, 32, False, False, False), "plain"),
    "mask": (("cuda", torch.float32, 1024, 1024, 16, True, False, False), "plain"),
    "attention_dropout": (("cuda", torch.float32, 1024, 1024, 16, False, True, False), "plain"),
    "weight_return": (("cuda", torch.float32, 1024, 1024, 16, False, False, True), "plain"),
    "cpu": (("cpu", torch.float32, 1024, 1024, 16, False, False, False), "plain"),
    "tk_over_2048": (("cuda", torch.float32, 1024, 4096, 16, False, False, False), "plain"),
    "tk_ragged": (("cuda", torch.float32, 1024, 1000, 16, False, False, False), "headpacked"),
    "tq_ragged": (("cuda", torch.float32, 1000, 1024, 16, False, False, False), "plain"),
    "d128_f32": (("cuda", torch.float32, 1024, 1024, 128, False, False, False), "headpacked"),
    "d128_bf16": (("cuda", torch.bfloat16, 1024, 1024, 128, False, False, False), "flash"),
    "d128_bf16_long_keys": (("cuda", torch.bfloat16, 1024, 4096, 128, False, False, False),
                            "flash"),
    "d128_bf16_ragged_keys": (("cuda", torch.bfloat16, 1024, 1000, 128, False, False, False),
                              "headpacked"),
    # No kernel instance for these: they take the kernel route and the
    # wrapper raises (test_kernel_route_raises_without_an_instance).
    "d256_bf16_no_instance": (("cuda", torch.bfloat16, 1024, 1024, 256, False, False, False),
                              "flash"),
    "f16_no_instance": (("cuda", torch.float16, 1024, 1024, 16, False, False, False),
                        "headpacked"),
}


@pytest.mark.parametrize("case", list(GATES))
def test_attention_route_gates(case):
    """The semantic and tileability gates of _flash_eligible and
    _headpack_eligible (tests/test_flash_attn.py), without the TPU-measured
    performance gates; the flagship's 139 tokens stay on the plain path."""
    (device, dtype, tq, tk, d_k, mask, dropout, weights), want = GATES[case]
    assert attention_route(device, dtype, tq, tk, d_k, has_mask=mask, dropout_active=dropout,
                           return_weights=weights) == want


def _jax_mha_pair(d_model, heads, x, dtype="float32"):
    import jax
    import jax.numpy as jnp

    from eyegaze_tpu.models.transformer import MultiHeadAttention as JaxMHA

    jm = JaxMHA(d_model, heads, dtype=getattr(jnp, dtype))
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), x, x, x)["params"])
    tm = MultiHeadAttention(d_model, heads, device=CPU, dtype=getattr(torch, dtype))
    tm.load_state_dict({f"{n}.{p}": torch.tensor(params[n]["kernel"].T if p == "weight"
                                                 else params[n]["bias"])
                        for n in ("q_proj", "k_proj", "v_proj", "out_proj")
                        for p in ("weight", "bias")}, strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("mask_shape", ["keys", "full"])
def test_masked_mha_matches_jax(mask_shape):
    """mask == 0 fills -1e9 before the softmax; (B, 1, 1, Tk) and
    (B, 1, Tq, Tk) masks, with the weights returned; f32 at 1e-5."""
    import jax.numpy as jnp

    r = np.random.default_rng(4)
    x = r.normal(size=(2, 48, 32)).astype(np.float32)
    mem = r.normal(size=(2, 40, 32)).astype(np.float32)
    shape = (2, 1, 1, 40) if mask_shape == "keys" else (2, 1, 48, 40)
    mask = (r.random(shape) > 0.3).astype(np.int32)
    mask[..., 0] = 1  # every query keeps a key
    jm, params, tm = _jax_mha_pair(32, 4, x)
    want, want_w = jm.apply({"params": params}, x, mem, mem, attn_mask=jnp.asarray(mask),
                            return_weights=True)
    with torch.no_grad():
        got, got_w = tm(torch.from_numpy(x), torch.from_numpy(mem), torch.from_numpy(mem),
                        torch.from_numpy(mask), return_weights=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5, atol=1e-6)
    assert float(got_w.numpy()[np.broadcast_to(mask, got_w.shape) == 0].max()) == 0.0


def test_bf16_mha_matches_jax():
    """bf16 compute and inputs against the JAX MHA at dtype bf16, with scores
    of several units: f32 scores from bf16 operands (the JAX contract) agree
    to one bf16 rounding of the largest output; scores rounded to bf16 first
    would be 0.0625 off here."""
    import jax.numpy as jnp

    x = (np.random.default_rng(5).normal(size=(2, 128, 64)) * 2).astype(np.float32)
    jm, params, tm = _jax_mha_pair(64, 4, x, "bfloat16")
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jm.apply({"params": params}, xb, xb, xb).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(xt, xt, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())


def test_wrapper_rejects_bad_inputs():
    x = torch.zeros((2, 16, 4, 16))
    before = dict(attention.launch_count)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.headpacked_attention(x.double(), x.double(), x.double(), 0.25)
    with pytest.raises(TypeError, match="mismatch"):
        attention.headpacked_attention(x, x.bfloat16(), x, 0.25)
    with pytest.raises(ValueError, match="shape"):
        attention.headpacked_attention(x, x[:, :, :3], x[:, :, :3], 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_attention(*(x.transpose(2, 3),) * 3, 0.25)
    with pytest.raises(ValueError, match="4-d"):
        attention.flash_attention(x[0], x[0], x[0], 0.25)
    with pytest.raises(ValueError, match="zero keys"):
        attention.headpacked_attention(x, x[:, :0], x[:, :0], 0.25)
    with pytest.raises(RuntimeError, match="no attention kernel"):
        attention._launch("flash_attention", x, x, x, 0.25, t_dim=2, h_dim=1)
    assert attention.launch_count == before


def test_twin_has_autograd_on_cpu():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv((1, 32, 2, 16), seed=6))
    attention.headpacked_attention(q, k, v, 0.25).square().sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))


def _assert_within_bf16_bound(got, want, terms):
    """Kernel vs twin in bf16: each side rounds every probability to bf16
    (2**-9 relative), the kernel unnormalised and the twin normalised, and
    its output once more (2**-8 relative), so |got - want| <= 2**-8 *
    sum_j p_j |v_j| + 2**-7 |want|; ``terms`` is that sum, the twin on |v|."""
    err = (got.float() - want.float()).abs()
    bound = 2.0 ** -8 * terms.float() + 2.0 ** -7 * want.float().abs() + 1e-6
    assert bool((err <= bound).all()), float((err / bound).max())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


# (B, Tq, H, d) and Tk (None: Tq): every head dim, and Tq, Tk in {1, 65, 200,
# 257, 1000, 1024}, ragged against the bf16 instance's 64-row, 64-key tiles
# and the f32 instance's 64 R-row blocks, 64-key tiles (fewer at d >= 64)
# and 8- or 16-key softmax chunks.
KERNEL_CASES = {
    "art": ((8, 1024, 8, 16), None),
    "d16_b1": ((1, 1024, 8, 16), None),
    "ragged": ((3, 200, 8, 16), None),
    "d16_tq257_tk65": ((16, 257, 8, 16), 65),
    "d16_tq1_tk1024": ((3, 1, 8, 16), 1024),
    "d64": ((2, 256, 4, 64), None),
    "d16_tq1_tk1": ((3, 1, 8, 16), 1),
    "d32_tq1000": ((8, 1000, 4, 32), None),
    "d32_tq1000_tk1024": ((2, 1000, 4, 32), 1024),
    "d32_tq1024_tk200": ((2, 1024, 4, 32), 200),
    "d64_tq1_tk1000": ((2, 1, 4, 64), 1000),
    "d128_tq200_tk1": ((2, 200, 2, 128), 1),
    "d128_tq1024_tk1000": ((2, 1024, 2, 128), 1000),
}
# The f32 launch's query rows per thread: 4 at d = 16 and 2 at d = 32 where
# that grid still gives every SM a block (256 blocks here, against 132 SMs
# on an H100), else 1 (24-64 blocks).
F32_ROWS_PER_THREAD = {"art": 4, "d16_b1": 1, "d16_tq257_tk65": 4, "d16_tq1_tk1024": 1,
                       "d32_tq1000": 2, "d32_tq1000_tk1024": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_headpacked_kernel_matches_twin_on_card(case, dtype):
    """f32: 1e-5, relative and absolute (the sums differ in order; an output
    near zero is a sum that cancels, whose error scales with its O(1) terms).
    bf16: within the rounding bound of ``_assert_within_bf16_bound``."""
    dev = _card()
    shape, kv_len = KERNEL_CASES[case]
    x = [torch.from_numpy(a).to(dev, getattr(torch, dtype))
         for a in _qkv(shape, seed=7, kv_len=kv_len)]
    if dtype == "float32" and case in F32_ROWS_PER_THREAD:
        b, tq, h, d = shape
        assert attention.f32_rows_per_thread(b, h, tq, d) == F32_ROWS_PER_THREAD[case]
    before = attention.launch_count["headpacked_attention"]
    before_bf16 = attention.bf16_launch_count["headpacked_attention"]
    got = attention.headpacked_attention(*x, 0.25)
    torch.cuda.synchronize()
    assert attention.launch_count["headpacked_attention"] == before + 1
    assert (attention.bf16_launch_count["headpacked_attention"]
            == before_bf16 + (dtype == "bfloat16"))
    q, k, v = (t.transpose(1, 2) for t in x)
    want = attention.attention_reference(q, k, v, 0.25).transpose(1, 2)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        terms = attention.attention_reference(q, k, v.abs(), 0.25).transpose(1, 2)
        _assert_within_bf16_bound(got, want, terms)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 1], ids=["wide_rows", "one_row"])
def test_f32_kernel_stages_unaligned_rows_on_card(batch):
    """Head-packed f32 views into (B, T, H * d + 2) tensors: a time stride of
    130 floats, not a multiple of 4, so K and V rows are not 16-byte aligned
    and the kernel stages them element by element; a negative scale and a
    ragged Tk (1000) besides, at 4 and at 1 query rows per thread."""
    dev = _card()
    t, h, d = 1000, 8, 16
    r = np.random.default_rng(10)
    x = [torch.from_numpy(r.normal(size=(batch, t, h * d + 2)).astype(np.float32)).to(dev)
         [..., :h * d].unflatten(-1, (h, d)) for _ in range(3)]
    assert x[1].stride(1) == h * d + 2 and x[1].stride(1) % 4 != 0
    assert attention.f32_rows_per_thread(batch, h, t, d) == (4 if batch == 8 else 1)
    before = attention.launch_count["headpacked_attention"]
    got = attention.headpacked_attention(*x, -0.25)
    torch.cuda.synchronize()
    assert attention.launch_count["headpacked_attention"] == before + 1
    want = attention.attention_reference(*(a.transpose(1, 2) for a in x), -0.25).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "transposed_views"])
@pytest.mark.parametrize("shape,kv_len", [((2, 8, 1024, 128), None), ((2, 4, 1000, 64), 1),
                                          ((1, 8, 200, 16), 1000)],
                         ids=["k4", "d64_tk1", "d16_tq200_tk1000"])
def test_flash_kernel_matches_twin_on_card(shape, kv_len, views):
    """bf16 (B, H, T, d) inputs, contiguous or, as the flash route passes
    them, (B, T, H, d) tensors seen through ``transpose(1, 2)``."""
    dev = _card()
    b, h, t, d = shape
    x = [torch.from_numpy(a).to(dev, torch.bfloat16)
         for a in _qkv((b, t, h, d), seed=8, kv_len=kv_len)]
    x = [a.transpose(1, 2) if views else a.transpose(1, 2).contiguous() for a in x]
    assert x[0].is_contiguous() != views
    before = attention.launch_count["flash_attention"]
    before_bf16 = attention.bf16_launch_count["flash_attention"]
    got = attention.flash_attention(*x, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert attention.launch_count["flash_attention"] == before + 1
    assert attention.bf16_launch_count["flash_attention"] == before_bf16 + 1
    want = attention.attention_reference(*x, 1.0 / math.sqrt(d))
    terms = attention.attention_reference(x[0], x[1], x[2].abs(), 1.0 / math.sqrt(d))
    _assert_within_bf16_bound(got, want, terms)


@pytest.mark.cuda
def test_kernel_route_raises_on_grad_and_mha_launches_it():
    """Under grad both kernel routes train: the head-packed route (f32: the
    kernel forward, one stock backward call, the plain path's gradients) and
    the flash route (bf16 d_k 128: the kernel forward with its log-sum-exp,
    K4's dQ and dK/dV backward kernels, the plain path's gradients within 2**-5 of
    each tensor's largest |entry|, the bf16 bound of the forward's output).
    Without grad each launches its kernel once."""
    dev = _card()
    mha = MultiHeadAttention(128, 8, device=dev).eval()
    x = torch.randn(2, 1024, 128, device=dev)
    launched = attention.launch_count["headpacked_attention"]
    backward = attention.backward_count["headpacked_attention"]
    mha(x, x, x).square().sum().backward()
    assert attention.launch_count["headpacked_attention"] == launched + 1
    assert attention.backward_count["headpacked_attention"] == backward + 1
    got = [p.grad.clone() for p in mha.parameters()]
    mha.zero_grad()
    mha(x, x, x, return_weights=True)[0].square().sum().backward()  # the plain path
    largest = max(float(p.grad.abs().max()) for p in mha.parameters())
    for (name, p), g in zip(mha.named_parameters(), got):
        # k_proj's bias gets a gradient that is zero in exact arithmetic (a
        # softmax ignores a shift of its row) and rounding noise on both paths.
        atol = 1e-6 * largest if name == "k_proj.bias" else 1e-4 * float(p.grad.abs().max())
        torch.testing.assert_close(g, p.grad, rtol=1e-4, atol=atol, msg=name)
    flash = MultiHeadAttention(1024, 8, device=dev, dtype=torch.bfloat16).eval()
    y = torch.randn(2, 1024, 1024, device=dev)
    before = (attention.launch_count["flash_attention"],
              attention.backward_launch_count["two_kernel"])
    flash(y, y, y).float().square().sum().backward()
    assert (attention.launch_count["flash_attention"],
            attention.backward_launch_count["two_kernel"]) == (before[0] + 1, before[1] + 2)
    got = [p.grad.clone() for p in flash.parameters()]
    flash.zero_grad()
    flash(y, y, y, return_weights=True)[0].float().square().sum().backward()
    largest = max(float(p.grad.abs().max()) for p in flash.parameters())
    for (name, p), g in zip(flash.named_parameters(), got):
        atol = 2.0 ** -5 * (largest if name == "k_proj.bias" else float(p.grad.abs().max()))
        torch.testing.assert_close(g, p.grad, rtol=0, atol=atol, msg=name)
    before = attention.launch_count["headpacked_attention"]
    with torch.no_grad():
        out = mha(x, x, x)
        plain = mha(x, x, x, return_weights=True)[0]  # the weights force the plain path
    assert attention.launch_count["headpacked_attention"] == before + 1
    torch.testing.assert_close(out, plain, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_headpacked_function_trains_on_the_card():
    """ART's training shape: the kernel forward and the stock-op backward
    give autograd-through-the-twin's gradients (1e-4 of each one's largest
    |value|), one launch and one backward call."""
    dev = _card()
    q, k, v, g = (torch.from_numpy(a).to(dev) for a in _qkv((16, 1024, 8, 16), seed=11)
                  + _qkv((16, 1024, 8, 16), seed=12)[:1])
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    launched = attention.launch_count["headpacked_attention"]
    backward = attention.backward_count["headpacked_attention"]
    got = torch.autograd.grad(attention.headpacked_attention(q, k, v, 0.25), (q, k, v), g)
    assert attention.launch_count["headpacked_attention"] == launched + 1
    assert attention.backward_count["headpacked_attention"] == backward + 1
    ref = attention.attention_reference(*(x.transpose(1, 2) for x in (q, k, v)), 0.25)
    want = torch.autograd.grad(ref.transpose(1, 2), (q, k, v), g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d_model,heads,dtype", [(2048, 8, torch.bfloat16),
                                                 (128, 8, torch.float16)],
                         ids=["d256_bf16", "f16"])
def test_kernel_route_raises_without_an_instance(d_model, heads, dtype):
    """A tileable CUDA call whose head dim or dtype the kernel is not built
    for raises in the wrapper; it never runs the plain path on the card."""
    dev = _card()
    mha = MultiHeadAttention(d_model, heads, device=dev, dtype=dtype).eval()
    x = torch.randn(1, 1024, d_model, device=dev, dtype=dtype)
    before = dict(attention.launch_count)
    with torch.no_grad(), pytest.raises((ValueError, TypeError), match="head dim|bfloat16"):
        mha(x, x, x)
    assert attention.launch_count == before


@pytest.fixture
def _no_tf32():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_art_denoiser_launches_the_kernel_on_card(_no_tf32, dtype):
    """Every attention call of an ART forward with ART's 6 + 6 layers at a
    small width (d_k 16; 6 encoder + 2 x 6 decoder = 18) launches the
    head-packed entry point's instance of the compute type.  f32: the card
    agrees with the same weights on the CPU to 1e-4 (TF32 off for matmuls
    and cuDNN).  bf16: to 2**-5 of the largest output (8 bf16 steps there),
    the bound tests/test_torch_art.py sets between the port and JAX: the card
    sums in another order and rounds the kernel's probabilities unnormalised,
    and each flipped bf16 rounding spreads over its row through the post-LN
    blocks."""
    from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
    from eyegaze_tpu_torch.serving import ArtDenoiser

    dev = _card()
    cfg = ArtConfig(in_channels=8, out_channels=8, embedding_size=64, num_heads=4,
                    feedforward_size=64, max_len=256)
    model = ArtifactRemovalTransformer(cfg, device=CPU, generator=torch.Generator().manual_seed(0),
                                       dtype=getattr(torch, dtype))
    noisy = np.random.default_rng(9).normal(size=(5, 8, 256)).astype(np.float32)
    want = ArtDenoiser(model, device=CPU, batch_buckets=(2, 4)).predict(noisy)["denoised"]
    den = ArtDenoiser(model, device=dev, batch_buckets=(2, 4))
    before, before_bf16 = dict(attention.launch_count), dict(attention.bf16_launch_count)
    got = den.predict(noisy)["denoised"]  # chunks of 4 and 1 (padded to 2): 2 forwards
    assert attention.launch_count == {**before,
                                      "headpacked_attention": before["headpacked_attention"] + 36}
    bf16_launches = 36 if dtype == "bfloat16" else 0
    assert attention.bf16_launch_count == {
        **before_bf16,
        "headpacked_attention": before_bf16["headpacked_attention"] + bf16_launches}
    tol = 1e-4 if dtype == "float32" else 2.0 ** -5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0 if dtype == "bfloat16" else tol, atol=tol)
