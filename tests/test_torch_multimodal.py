"""The multimodal fuzzy-gating composite in the port against the JAX package,
and its serving.

- ``FuzzyGatingFusion`` in all four modes, from the same parameters (each
  moved off its init by a seeded offset): the fused logits, alpha, every
  leaf of ``aux_info``, ``temp_reg`` and the gradients of a loss on all of
  them with respect to the nine parameters, within 1e-6 (elementwise
  float32; a parameter a mode does not reach has a zero gradient in JAX
  and none in the port).
- The tiny composite (``scripts/train_multimodal.py``'s ``--tiny`` sizes:
  img 64, ViT embed 64, depth 1, 4 heads; EEG d_model 64, 1 layer, 4 heads,
  d_ff 128, max_len 512) on JAX's parameters through
  ``convert.multimodal_state_dict_from_flax`` (equal to the JAX exporter's
  state_dict): in float32 each output within 1e-6 of its largest |value|
  where that holds (the gate and the EEG logits), the ViT's logits and the
  fused logits they enter within rtol = atol = 2e-3, the flagship's bound
  (tests/test_torch_dual_eeg.py; seen: 1.6e-6 relative); in bf16 against
  the Flax bf16 model, within 2**-5 of each output's largest |value|.
- ``MultimodalPredictor.from_checkpoint`` on an orbax checkpoint exported
  by ``scripts/export_torch_checkpoint.py``, with the ``model.multimodal``
  stamp and without it (shapes), against the JAX ``MultimodalPredictor``
  on the same checkpoint: every constructor field equal; each output within
  2**-5 of its largest |value| of the eager Flax bf16 model's, and within
  2**-5 of the composite's largest |logit| (alpha: of 1) of the jitted JAX
  predictor's, whose own bf16 roundings move its logits from the eager
  model's by up to 2**-7 of that scale; padding and chunking of the dict
  output.
- Dict outputs through ``DynamicBatcher``, ``labels`` kept a list, and a
  ``serve --kind multimodal`` round trip over HTTP on the CPU.
"""

import dataclasses
import importlib.util
import io
import json
import shutil
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.data import image_fusion as jax_fusion
from eyegaze_tpu.models import fuzzy_fusion as jax_fuzzy
from eyegaze_tpu.models.multimodal import MultimodalFusionModel as JaxMultimodal
from eyegaze_tpu.models.torch_port import export_multimodal_state_dict
from eyegaze_tpu.serving import MultimodalPredictor as JaxMultimodalPredictor
from eyegaze_tpu.train.checkpoint import CheckpointManager
from eyegaze_tpu.train.optim import make_optimizer
from eyegaze_tpu.train.state import create_train_state
from eyegaze_tpu_torch import serve
from eyegaze_tpu_torch.data.image_fusion import imagenet_normalize, to_unit_float
from eyegaze_tpu_torch.models import convert
from eyegaze_tpu_torch.models.fuzzy_fusion import PARAM_NAMES, VALID_MODES, FuzzyGatingFusion
from eyegaze_tpu_torch.models.multimodal import FIELDS, MultimodalFusionModel
from eyegaze_tpu_torch.serving import DynamicBatcher, MultimodalPredictor

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SHARE = 2.0 ** -5
F32_SHARE = 1e-6
TOL = 2e-3
TIMEOUT = 120
# scripts/train_multimodal.py:91-97, at the tiny img 64.
TINY = dict(img_size=64, vit_embed_dim=64, vit_depth=1, vit_num_heads=4, eeg_in_channels=32,
            eeg_d_model=64, eeg_num_layers=1, eeg_num_heads=4, eeg_d_ff=128, eeg_max_len=512)
T = 512
# The served checkpoint: tests/test_serving.py's tiny composite.
SERVED = dict(num_classes=3, gaze_fusion_mode="concat", fuzzy_mode="full", eeg_in_channels=8,
              eeg_d_model=32, eeg_num_layers=1, eeg_num_heads=4, eeg_d_ff=64, eeg_max_len=128,
              use_spectrogram=False, vit_embed_dim=64, vit_depth=2, vit_num_heads=4, img_size=32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=""):
    """{path: value} of a nested dict; None is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("mode", VALID_MODES)
def test_fuzzy_gating_matches_jax(mode):
    r = np.random.default_rng(0)
    img, eeg = (r.normal(0, 2, (7, 3)).astype(np.float32) for _ in range(2))
    img[0] = [9.0, -4.0, -5.0]  # a confident row: low entropy
    jm = jax_fuzzy.FuzzyGatingFusion(num_classes=3, mode=mode)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), img, eeg)["params"])
    port = FuzzyGatingFusion(3, mode, device=CPU)
    assert tuple(n for n, _ in port.named_parameters()) == PARAM_NAMES
    for name in PARAM_NAMES:  # the same init
        np.testing.assert_allclose(getattr(port, name).detach().numpy(), params[name],
                                   rtol=1e-6, err_msg=name)
    params = {k: (v + r.normal(0, 0.2, np.shape(v))).astype(np.float32) for k, v in params.items()}
    port.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, strict=True)
    wf, wa = r.normal(size=(7, 3)).astype(np.float32), r.normal(size=7).astype(np.float32)

    def jax_loss(p):
        fused, alpha, aux = jm.apply({"params": p}, img, eeg)
        reg = jm.apply({"params": p}, method=jm.temperature_regularization)
        return jnp.sum(fused * wf) + jnp.sum(alpha * wa) + 3.0 * reg, (fused, alpha, aux, reg)

    (_, (fused, alpha, aux, reg)), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    got_fused, got_alpha, got_aux = port(torch.from_numpy(img), torch.from_numpy(eeg))
    got_reg = port.temperature_regularization()
    loss = ((got_fused * torch.from_numpy(wf)).sum() + (got_alpha * torch.from_numpy(wa)).sum()
            + 3.0 * got_reg)
    loss.backward()
    np.testing.assert_allclose(got_fused.detach().numpy(), fused, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_alpha.detach().numpy(), alpha, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_reg.item(), float(reg), rtol=1e-6, atol=1e-7)
    want_aux, have_aux = _leaves(aux), _leaves(got_aux)
    assert want_aux.keys() == have_aux.keys()
    for k, w in want_aux.items():
        if w is None:
            assert have_aux[k] is None, k
        else:
            assert not have_aux[k].requires_grad, k
            np.testing.assert_allclose(have_aux[k].numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    for name in PARAM_NAMES:
        g = getattr(port, name).grad
        g = np.zeros(np.shape(params[name]), np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, grads[name], rtol=1e-5, atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="Invalid mode"):
        FuzzyGatingFusion(3, "soft", device=CPU)


def _inputs(n, seed, size, channels, t):
    r = np.random.default_rng(seed)
    i1, i2 = (r.integers(0, 256, (n, 3, size, size), dtype=np.uint8) for _ in range(2))
    e1, e2 = (r.normal(size=(n, channels, t)).astype(np.float32) for _ in range(2))
    return i1, i2, e1, e2


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny composite, its parameters and normalized inputs."""
    jm = JaxMultimodal(**TINY, dropout=0.0)
    i1, i2, e1, e2 = _inputs(3, 1, 64, 32, T)
    norm = [imagenet_normalize(to_unit_float(torch.from_numpy(x))).numpy() for x in (i1, i2)]
    x = (*norm, e1, e2)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), *x)[
        "params"])
    return params, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_composite_matches_jax(tiny, dtype):
    params, x = tiny
    state = convert.multimodal_state_dict_from_flax(params)
    exported = export_multimodal_state_dict(params)
    assert state.keys() == exported.keys()
    for k in state:
        np.testing.assert_array_equal(state[k], np.asarray(exported[k]), err_msg=k)
    model = MultimodalFusionModel(**TINY, device=CPU, dtype=getattr(torch, dtype),
                                  generator=torch.Generator().manual_seed(1))
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(a) for a in x))
    want = JaxMultimodal(**TINY, dtype=jnp.dtype(dtype)).apply({"params": params}, *x)
    assert set(got) == set(want) == {"logits", "img_logits", "eeg_logits", "alpha", "aux_info",
                                     "temp_reg"}
    for k in ("logits", "img_logits", "eeg_logits", "alpha", "temp_reg"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == np.float32 and g.shape == w.shape, k
        largest = max(float(np.abs(w).max()), 1e-30)
        if dtype == "bfloat16":
            np.testing.assert_allclose(g, w, rtol=0, atol=SHARE * largest, err_msg=k)
        elif k in ("logits", "img_logits"):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_SHARE * largest, err_msg=k)
    assert _leaves(got["aux_info"]).keys() == _leaves(want["aux_info"]).keys()


def _export(tmp_path, stamp: bool):
    """tests/test_serving.py's tiny composite saved as an orbax checkpoint
    by the JAX ``CheckpointManager``, exported by the export script's
    ``main``, its meta copied beside; returns (orbax dir, state_dict, model)."""
    jm = JaxMultimodal(**SERVED)
    zi = jnp.zeros((1, 3, 32, 32), jnp.float32)
    ze = jnp.zeros((1, 8, 4 * jm.eeg_max_len), jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), zi, zi, ze, ze)
    mc = {"num_labels": 3, "img_size": 32, "fusion_mode": "concat", "fuzzy_mode": "full",
          "in_channels": 8, "num_heads": 4, "vit_num_heads": 4}
    if stamp:
        mc["multimodal"] = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
                            if f.name not in ("parent", "name", "dtype")}
    state = create_train_state(jm, variables, make_optimizer(1e-3))
    CheckpointManager(tmp_path / "ckpt").save_if_best(0.5, state, config={"model": mc})
    ckpt = tmp_path / "ckpt" / "best_model"
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", ROOT / "scripts" / "export_torch_checkpoint.py")
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    out = tmp_path / "multimodal.pt"
    assert export.main([str(ckpt), "--out", str(out)]) == 0
    shutil.copy(ckpt.parent / "best_model.meta.json", out.with_suffix(".meta.json"))
    return ckpt, out, jm


@pytest.fixture(scope="module")
def stamped(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("stamped"), stamp=True)


@pytest.mark.parametrize("stamp", [True, False], ids=["stamped", "inferred"])
def test_from_checkpoint_matches_the_jax_predictor(stamp, stamped, tmp_path):
    ckpt, path, jm = stamped if stamp else _export(tmp_path, stamp=False)
    pred = MultimodalPredictor.from_checkpoint(path, device=CPU, batch_buckets=(4, 2))
    assert pred.buckets == (2, 4) and pred.model.dtype == torch.bfloat16
    for name in FIELDS:
        assert getattr(pred.model, name) == getattr(jm, name), name
    x = _inputs(5, 5, 32, 8, 4 * jm.eeg_max_len)
    got = pred.predict(*x)
    jax_pred = JaxMultimodalPredictor.from_checkpoint(ckpt, batch_buckets=(2, 4))
    want = jax_pred.predict(*x)
    assert set(got) == set(want) == {"logits", "probs", "preds", "labels", "img_logits",
                                     "eeg_logits", "alpha"}
    assert isinstance(got["labels"], list) and len(got["labels"]) == 5
    # JAX's predictor is jitted, and XLA keeps some fused bf16 intermediates
    # in f32: on this model its logits move by up to 2**-7 of the largest
    # |logit| from the eager Flax bf16 model's.  So the port is held to the
    # eager model output by output, and to the predictor by the composite's
    # one logit scale (the largest |logit| of its three logits outputs).
    eager = jax_pred.model.apply({"params": jax_pred.params},
                                 *(jax_fusion.imagenet_normalize(jax_fusion.to_unit_float(
                                     jnp.asarray(a))) for a in x[:2]), *x[2:])
    scale = max(float(np.abs(np.asarray(want[k])).max())
                for k in ("logits", "img_logits", "eeg_logits"))
    for k in ("logits", "img_logits", "eeg_logits", "alpha"):
        assert got[k].shape == ((5,) if k == "alpha" else (5, 3)), k
        ref = np.asarray(eager[k])
        np.testing.assert_allclose(got[k], ref, rtol=0, atol=SHARE * np.abs(ref).max(),
                                   err_msg=k)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=0, err_msg=k,
                                   atol=SHARE * (1.0 if k == "alpha" else scale))
    # Padding and chunking (5 = 4 + 1 padded to 2) give one direct forward's rows.
    with torch.inference_mode():
        direct = pred.model(*(imagenet_normalize(to_unit_float(torch.from_numpy(a)))
                              for a in x[:2]), *(torch.from_numpy(a) for a in x[2:]))
    for k in ("logits", "img_logits", "eeg_logits", "alpha"):
        np.testing.assert_allclose(got[k], direct[k].numpy(), rtol=0,
                                   atol=SHARE * np.abs(direct[k].numpy()).max(), err_msg=k)
    np.testing.assert_allclose(got["probs"].sum(-1), 1.0, atol=1e-6)
    pred.warmup()


def test_dict_outputs_through_the_batcher(stamped):
    _, path, jm = stamped
    pred = MultimodalPredictor.from_checkpoint(path, device=CPU, batch_buckets=(8,))
    x = _inputs(4, 6, 32, 8, 4 * jm.eeg_max_len)
    want = pred.predict(*x)
    batcher = DynamicBatcher(pred, max_wait_ms=500)
    results = [None] * 4
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, batcher.predict(*(a[i:i + 1] for a in x)))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    for i, out in enumerate(results):
        for k in ("logits", "probs", "preds", "img_logits", "eeg_logits", "alpha"):
            np.testing.assert_array_equal(out[k], want[k][i:i + 1], err_msg=k)
        assert out["labels"] == want["labels"][i:i + 1]
    assert batcher.stats["requests"] == 4 and batcher.stats["dispatches"] < 4


def test_multimodal_kind_over_http(stamped, tmp_path):
    _, path, jm = stamped
    assert serve.sniff_kind(path) == "multimodal"  # the stamp
    bare = tmp_path / "bare.pt"
    bare.write_bytes(path.read_bytes())
    assert serve.sniff_kind(bare) == "multimodal"  # no meta: gaze_encoder. keys
    x = _inputs(3, 7, 32, 8, 4 * jm.eeg_max_len)
    want = MultimodalPredictor.from_checkpoint(path, device=CPU, batch_buckets=(4,)).predict(*x)
    bound = []
    argv = ["--checkpoint", str(path), "--device", "cpu", "--port", "0", "--buckets", "4"]
    thread = threading.Thread(target=serve.main, args=(argv, bound.append), daemon=True)
    thread.start()
    for _ in range(TIMEOUT * 10):
        if bound or not thread.is_alive():
            break
        thread.join(0.1)
    assert bound, "the server did not start"
    base = f"http://127.0.0.1:{bound[0].server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/info", timeout=TIMEOUT) as r:
            info = json.load(r)
        assert info["kind"] == "multimodal"
        assert info["inputs"] == ["img1", "img2", "eeg1", "eeg2"]
        assert info["input_spec"]["eeg1"] == ["N", 8, "T"]
        buf = io.BytesIO()
        np.savez(buf, **dict(zip(("img1", "img2", "eeg1", "eeg2"), x)))
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            got = json.load(r)
    finally:
        bound[0].shutdown()
        thread.join(TIMEOUT)
    assert not thread.is_alive()
    for k in ("logits", "img_logits", "eeg_logits", "alpha"):
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), want[k], err_msg=k)
    assert got["labels"] == want["labels"]
