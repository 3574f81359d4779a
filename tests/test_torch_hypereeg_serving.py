"""HyperEEG's serving in the port against the JAX package.

- ``HyperEEGPredictor.from_checkpoint`` with the ``model.hypereeg`` stamp
  and without it (fields inferred from the state_dict), against the JAX
  predictor's ``from_checkpoint`` on the same parameters saved by the JAX
  ``CheckpointManager``: every constructor field equal, logits within
  2**-5 of the largest |logit| (bf16 both, the repo's bf16 bound).
- ``serve.sniff_kind`` with and without a meta, and one request through
  ``serve --kind hypereeg`` over HTTP on the CPU, equal to a direct predict.
"""

import dataclasses
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from eyegaze_tpu.models import hypereeg as jax_hypereeg
from eyegaze_tpu.serving import HyperEEGPredictor as JaxHyperEEGPredictor
from eyegaze_tpu.train.checkpoint import CheckpointManager
from eyegaze_tpu.train.optim import make_optimizer
from eyegaze_tpu.train.state import create_train_state
from eyegaze_tpu_torch import serve
from eyegaze_tpu_torch.models import convert, hypereeg
from eyegaze_tpu_torch.serving import HyperEEGPredictor

CPU = torch.device("cpu")
SHARE = 2.0 ** -5
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(n, t, seed, c=8):
    r = np.random.default_rng(seed)
    return [r.normal(size=(n, c, t)).astype(np.float32) for _ in range(2)]


# The served checkpoints: a stamped one with non-default widths, and an
# unstamped one whose other fields are the defaults JAX's inference keeps.
SERVED = {"stamped": ("no_uncertainty", dict(in_channels=8, embed_dim=32, num_heads=2,
                                            sinc_kernel_size=33)),
          "inferred": ("no_cross", dict(embed_dim=32))}


def _save(tmp_path, stamp: str):
    """The model's JAX parameters saved by the JAX ``CheckpointManager``
    and as a port checkpoint (state_dict + meta); returns (orbax dir, .pt
    path, the JAX model)."""
    ablation, geometry = SERVED[stamp]
    e1, e2 = _pairs(1, 256, 2)
    jm = jax_hypereeg.create_hypereeg_model(ablation, **geometry)
    variables = jm.init(jax.random.PRNGKey(0), e1, e2)
    mc = {}
    if stamp == "stamped":
        mc["hypereeg"] = {f: getattr(jm, f) for f in hypereeg.FIELDS}
    state = create_train_state(jm, variables, make_optimizer(1e-3))
    CheckpointManager(tmp_path / "ckpt").save_if_best(0.5, state, config={"model": mc})
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    path = tmp_path / "hypereeg.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                convert.hypereeg_state_dict_from_flax(params).items()}, path)
    path.with_suffix(".meta.json").write_text(json.dumps({"config": {"model": mc}}))
    return tmp_path / "ckpt" / "best_model", path, jm


@pytest.mark.parametrize("stamp", list(SERVED))
def test_from_checkpoint_matches_the_jax_predictor(stamp, tmp_path):
    ckpt, path, jm = _save(tmp_path, stamp)
    want = JaxHyperEEGPredictor.from_checkpoint(ckpt, batch_buckets=(4,))
    pred = HyperEEGPredictor.from_checkpoint(path, device=CPU, batch_buckets=(4, 1))
    assert pred.buckets == (1, 4) and pred.model.dtype == torch.bfloat16
    for f in dataclasses.fields(want.model):
        if f.name not in ("parent", "name", "dtype"):
            assert getattr(pred.model, f.name) == getattr(want.model, f.name), f.name
    e1, e2 = _pairs(6, 256, 3)  # 6 rows: a full bucket of 4, then 2 padded
    got, ref = pred.predict(e1, e2), want.predict(e1, e2)
    assert got["logits"].shape == (6, 3)
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=0,
                               atol=SHARE * float(np.abs(ref["logits"]).max()))


def test_hypereeg_kind_over_http(tmp_path):
    _, path, _ = _save(tmp_path, "stamped")
    assert serve.sniff_kind(path) == "hypereeg"  # the stamp
    bare = tmp_path / "bare.pt"
    bare.write_bytes(path.read_bytes())
    assert serve.sniff_kind(bare) == "hypereeg"  # no meta: its keys
    e1, e2 = _pairs(3, 256, 4)
    want = HyperEEGPredictor.from_checkpoint(path, device=CPU, batch_buckets=(4,)).predict(e1, e2)
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
        assert info["kind"] == "hypereeg" and info["inputs"] == ["eeg1", "eeg2"]
        assert info["input_spec"]["eeg1"] == ["N", 8, "T"]
        buf = io.BytesIO()
        np.savez(buf, eeg1=e1, eeg2=e2)
        req = urllib.request.Request(base + "/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            got = json.load(r)
    finally:
        bound[0].shutdown()
        thread.join(TIMEOUT)
    assert not thread.is_alive()
    np.testing.assert_array_equal(np.asarray(got["logits"], np.float32), want["logits"])
    assert got["labels"] == want["labels"]
