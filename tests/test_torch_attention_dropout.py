"""The ViT's attention dropout in the port, against Flax's
``broadcast_dropout``.

Flax's ``nn.MultiHeadDotProductAttention`` (the JAX ViT block and both
HyperEEG attentions) drops attention weights with one keep-mask of shape
(1, 1, Tq, Tk) per call, shared by every batch row and head, and scales the
kept weights by ``keep / keep_prob`` in the compute type.  These tests hold
``vit.dot_product_attention`` and ``vit.Attention`` to that, in float32 and
bf16:

- Flax's own weights show the shared mask (the reference's behaviour);
- in training, the zeroed positions of the port's weights are the same
  across batch rows and heads, and the kept ones are the softmax times
  ``1 / keep_prob``, both rounded to the compute type (0.9 is 0.8984375 in
  bf16), to the bit;
- through ``Attention``, a module whose queries and keys are zero and whose
  values are one-hot reads the mask back per batch row and head;
- at eval (and at dropout 0), the output equals the undropped formula to
  the bit.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from eyegaze_tpu_torch.models import vit

CPU = torch.device("cpu")
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(seed, b=3, h=4, tq=6, tk=7, d=8, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=(b, h, t, d)).astype(np.float32)).to(dtype)
            for t in (tq, tk, tk)]


def _undropped(q, k, v):
    """The attention without dropout, op for op: q scaled, the scores, the
    softmax and the product with v in the compute type."""
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(q.dtype)
    return torch.matmul(vit._softmax(torch.matmul(q, k.transpose(-1, -2))), v)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flax_shares_one_mask_over_batch_and_heads(dtype):
    r = np.random.default_rng(0)
    q, k = (jnp.asarray(r.normal(size=(3, 7, 4, 8)), DTYPES[dtype][1]) for _ in range(2))
    w = fnn.dot_product_attention_weights(q, k, dropout_rng=jax.random.PRNGKey(1),
                                          dropout_rate=0.4, deterministic=False)
    zero = np.asarray(w, np.float32) == 0.0  # (B, H, Tq, Tk)
    assert zero.any() and not zero.all()
    assert (zero == zero[:1, :1]).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dropped_weights_share_one_mask_and_scale_in_the_compute_type(dtype):
    tdt = DTYPES[dtype][0]
    tk = 7
    q, k, _ = _qkv(1, tk=tk, dtype=tdt)
    v = torch.eye(tk, dtype=tdt).expand(3, 4, tk, tk)  # the output is the weights
    torch.manual_seed(0)
    got = vit.dot_product_attention(q, k, v, dropout=0.1)
    want = _undropped(q, k, v)
    zero = got == 0
    assert zero.any() and not zero.all()
    assert (zero == zero[:1, :1]).all()  # one (Tq, Tk) mask for every row and head
    scale = torch.tensor(1.0, dtype=tdt) / torch.tensor(0.9, dtype=tdt)
    if tdt == torch.bfloat16:
        assert torch.tensor(0.9, dtype=tdt).item() == 0.8984375
        assert scale.item() == 1.109375
    np.testing.assert_array_equal(got[~zero].float().numpy(),
                                  (want * scale)[~zero].float().numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_module_reads_one_mask_per_call(dtype):
    """Queries and keys zero (uniform weights 1/T), values the tokens'
    one-hot rows and ``proj`` the identity: head h's output at query i holds
    keep[i, j] / (T keep_prob) at feature h * T + j."""
    tdt = DTYPES[dtype][0]
    b, t, heads = 3, 5, 4
    dim = heads * t
    attn = vit.Attention(dim, heads, dropout=0.5, device=CPU, dtype=tdt)
    with torch.no_grad():
        attn.qkv.weight.zero_()
        attn.qkv.bias.zero_()
        attn.qkv.weight[2 * dim:] = torch.eye(dim)
        attn.proj.weight.copy_(torch.eye(dim))
        attn.proj.bias.zero_()
    x = torch.zeros(b, t, dim)
    for j in range(t):
        x[:, j, j::t] = 1.0  # token j is feature j of every head
    torch.manual_seed(3)
    with torch.no_grad():
        out = attn.train()(x).float().reshape(b, t, heads, t)  # (B, Tq, H, Tk)
    kept = out != 0
    assert kept.any() and not kept.all()
    assert (kept == kept[:1, :, :1]).all()
    np.testing.assert_array_equal(np.unique(out[kept].numpy()),
                                  [np.float32(torch.tensor(1 / t, dtype=tdt).float()
                                              * torch.tensor(2.0, dtype=tdt).float())])
    with torch.no_grad():
        assert attn.eval()(x).float().ne(0).all()  # no dropout at eval


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_eval_output_is_the_undropped_formula_to_the_bit(dtype):
    tdt = DTYPES[dtype][0]
    q, k, v = _qkv(2, dtype=tdt)
    np.testing.assert_array_equal(vit.dot_product_attention(q, k, v).float().numpy(),
                                  _undropped(q, k, v).float().numpy())
    torch.manual_seed(0)
    block = vit.Block(16, 4, dropout=0.1, device=CPU, dtype=tdt).eval()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 9, 16)).astype(np.float32))
    a = block.attn
    h = block.norm1(x)
    qkv = a.qkv(h).reshape(2, 9, 3, 4, 4).permute(2, 0, 3, 1, 4)
    want = a.proj(_undropped(*qkv).transpose(1, 2).reshape(2, 9, 16))
    np.testing.assert_array_equal(a(h).detach().float().numpy(), want.detach().float().numpy())
