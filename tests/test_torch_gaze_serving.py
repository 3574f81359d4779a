"""Serving the gaze ViTs in the port: ``GazePredictor``, its
``from_checkpoint`` and the ``gaze`` kind of ``python -m
eyegaze_tpu_torch.serve``, on the CPU.

- Padding and chunking: uint8 requests of 1, 5 and 11 pairs through buckets
  (1, 8) give the rows of one direct forward of the normalized images
  (float32, 1e-5: another batch size may block the products differently).
- ``from_checkpoint``: kind and geometry read from a state_dict plus meta
  as the JAX exporter writes them (``backbone.`` early, ``encoder.`` late;
  embed from ``cls_token``, depth from the blocks, heads from
  ``vit_num_heads`` or max(embed // 64, 4)), bf16 compute, strict load;
  against the JAX ``GazePredictor`` with the Flax bf16 model on the same
  parameters and the same uint8 pairs, logits within 2**-5 of the largest
  |logit| (the bound of tests/test_torch_vit.py; JAX's forward is jitted
  here, which moves its own bf16 roundings).
- The datafusion kind through the constructor (a bare ViT behind the
  on-device paste and antialiased resize) against the JAX ``GazePredictor``
  the same way.
- The ``gaze`` kind over HTTP on 127.0.0.1 port 0 with ``--device cpu``:
  JSON and npz answers equal to a direct ``predict``, behind the dynamic
  batcher too, and a mis-shaped image refused before any device work.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eyegaze_tpu.models import vit as jax_vit
from eyegaze_tpu.serving import GazePredictor as JaxGazePredictor
from eyegaze_tpu_torch import serve
from eyegaze_tpu_torch.data.image_fusion import imagenet_normalize, to_unit_float
from eyegaze_tpu_torch.models import convert, vit
from eyegaze_tpu_torch.serving import DynamicBatcher, GazePredictor

CPU = torch.device("cpu")
IMG = 32
SMALL = dict(embed_dim=64, depth=2, num_heads=4)
SHARE = 2.0 ** -5
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(n, seed, size=IMG):
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, size=(n, 3, size, size), dtype=np.uint8) for _ in range(2)]


def _jax_params(kind, mode):
    cls = jax_vit.EarlyFusionViT if kind == "early" else jax_vit.LateFusionViT
    z = jnp.zeros((1, 3, IMG, IMG), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        cls(img_size=IMG, fusion_mode=mode, **SMALL).init)(jax.random.PRNGKey(0), z, z)["params"])


def _checkpoint(path, kind, mode, meta_model):
    params = _jax_params(kind, mode)
    state = (convert.gaze_early_state_dict_from_flax if kind == "early"
             else convert.gaze_late_state_dict_from_flax)(params)
    torch.save({k: torch.tensor(v) for k, v in state.items()}, path)
    if meta_model is not None:
        path.with_suffix(".meta.json").write_text(json.dumps({"config": {"model": meta_model}}))
    return params


@pytest.fixture(scope="module")
def late_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("late") / "model.pt"
    params = _checkpoint(path, "late", "full", {"kind": "late", "fusion_mode": "full",
                                                "num_labels": 3, "img_size": IMG,
                                                "vit_num_heads": 4})
    return path, params


def test_padding_and_chunking_give_the_direct_forward():
    model = vit.LateFusionViT(img_size=IMG, **SMALL, device=CPU,
                              generator=torch.Generator().manual_seed(0))
    pred = GazePredictor(model, device=CPU, batch_buckets=(8, 1))
    assert pred.buckets == (1, 8)
    a, b = _pairs(11, 1)
    with torch.inference_mode():
        want = model(*(imagenet_normalize(to_unit_float(torch.from_numpy(x))) for x in (a, b)))
    for n in (1, 5, 11):
        out = pred.predict(a[:n], b[:n])
        assert set(out) == {"logits", "probs", "preds", "labels"}
        assert out["logits"].shape == (n, 3) and out["logits"].dtype == np.float32
        np.testing.assert_allclose(out["logits"], want[:n].numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["probs"].sum(-1), 1.0, atol=1e-6)
        np.testing.assert_array_equal(out["preds"], out["logits"].argmax(-1))
        assert out["labels"] == [("Single", "Competition", "Cooperation")[p]
                                 for p in out["preds"]]
    pred.warmup()
    with pytest.raises(ValueError, match="image_norm"):
        GazePredictor(model, device=CPU, image_norm="none")


@pytest.mark.parametrize("kind,mode", [("early", "concat"), ("early", "multiply"),
                                       ("late", "full"), ("late", "add")])
def test_from_checkpoint_matches_the_jax_predictor(tmp_path, kind, mode):
    path = tmp_path / "model.pt"
    params = _checkpoint(path, kind, mode, {"kind": kind, "fusion_mode": mode,
                                            "img_size": IMG})
    pred = GazePredictor.from_checkpoint(path, device=CPU, batch_buckets=(1, 4))
    m = pred.model
    assert isinstance(m, vit.EarlyFusionViT if kind == "early" else vit.LateFusionViT)
    assert m.dtype == torch.bfloat16 and m.fusion_mode == mode and m.img_size == IMG
    enc = m.backbone if kind == "early" else m.encoder
    # No vit_num_heads in the meta: max(64 // 64, 4) heads.
    assert (enc.embed_dim, len(enc.blocks), enc.blocks[0].attn.num_heads) == (64, 2, 4)
    a, b = _pairs(3, 2)
    got = pred.predict(a, b)
    jax_cls = jax_vit.EarlyFusionViT if kind == "early" else jax_vit.LateFusionViT
    want = JaxGazePredictor(jax_cls(img_size=IMG, fusion_mode=mode, **SMALL, dtype=jnp.bfloat16),
                            params, batch_buckets=(1, 4)).predict(a, b)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=SHARE * np.abs(want["logits"]).max())


def test_from_checkpoint_reads_kind_and_heads(late_checkpoint, tmp_path):
    path, _ = late_checkpoint
    pred = GazePredictor.from_checkpoint(path, device=CPU)
    assert isinstance(pred.model, vit.LateFusionViT) and pred.buckets == (1, 8, 32)
    assert pred.model.encoder.blocks[0].attn.num_heads == 4  # the meta's vit_num_heads
    bare = tmp_path / "bare.pt"  # no meta: kind from the prefix, JAX's defaults
    bare.write_bytes(path.read_bytes())
    with pytest.raises(RuntimeError, match="size mismatch"):  # 224 and 'concat' by default
        GazePredictor.from_checkpoint(bare, device=CPU)
    meta = tmp_path / "other.json"
    meta.write_text(json.dumps({"config": {"model": {"fusion_mode": "full", "img_size": IMG}}}))
    pred = GazePredictor.from_checkpoint(bare, device=CPU, meta_path=meta)
    assert isinstance(pred.model, vit.LateFusionViT)
    for kind, match in (("datafusion", "datafusion"), ("early", "no backbone.cls_token")):
        meta.write_text(json.dumps({"config": {"model": {"kind": kind, "img_size": IMG}}}))
        with pytest.raises(ValueError, match=match):  # the meta's kind wins over the prefix
            GazePredictor.from_checkpoint(bare, device=CPU, meta_path=meta)


@pytest.mark.parametrize("mode,norm", [("horizontal", "vit"), ("vertical", "imagenet"),
                                       ("multiply", "vit")])
def test_datafusion_through_the_constructor_matches_jax(mode, norm):
    geometry = dict(img_size=IMG, **SMALL)
    z = jnp.zeros((1, 3, IMG, IMG), jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_vit.VisionTransformer(**geometry).init)(
        jax.random.PRNGKey(1), z)["params"])
    w = convert._Writer(params)
    convert._vit(w, "")
    model = vit.VisionTransformer(**geometry, device=CPU, dtype=torch.bfloat16,
                                  generator=torch.Generator().manual_seed(0))
    model.load_state_dict({k: torch.tensor(v) for k, v in w.state.items()}, strict=True)
    pred = GazePredictor(model, device=CPU, batch_buckets=(4,), data_fusion_mode=mode,
                         image_norm=norm)
    a, b = _pairs(3, 3)
    got = pred.predict(a, b)["logits"]
    want = JaxGazePredictor(jax_vit.VisionTransformer(**geometry, dtype=jnp.bfloat16), params,
                            batch_buckets=(4,), data_fusion_mode=mode,
                            image_norm=norm).predict(a, b)["logits"]
    np.testing.assert_allclose(got, want, rtol=0, atol=SHARE * np.abs(want).max())


def test_batcher_coalesces_gaze_requests(late_checkpoint):
    path, _ = late_checkpoint
    pred = GazePredictor.from_checkpoint(path, device=CPU, batch_buckets=(8,))
    a, b = _pairs(4, 4)
    want = pred.predict(a, b)
    batcher = DynamicBatcher(pred, max_wait_ms=500)
    results = [None] * 4
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, batcher.predict(a[i:i + 1], b[i:i + 1]))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    for i, out in enumerate(results):
        np.testing.assert_array_equal(out["logits"], want["logits"][i:i + 1])
        assert out["labels"] == want["labels"][i:i + 1]
    assert batcher.stats["requests"] == 4 and batcher.stats["dispatches"] < 4


class _Server:
    def __init__(self, *argv):
        self.argv, self.bound = list(argv), []

    def __enter__(self):
        self.thread = threading.Thread(target=serve.main, args=(self.argv, self.bound.append),
                                       daemon=True)
        self.thread.start()
        for _ in range(TIMEOUT * 10):
            if self.bound or not self.thread.is_alive():
                break
            self.thread.join(0.1)
        assert self.bound, "the server did not start"
        self.base = f"http://127.0.0.1:{self.bound[0].server_address[1]}"
        return self

    def __exit__(self, *exc):
        self.bound[0].shutdown()
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=TIMEOUT) as r:
            return json.load(r)

    def post(self, path, **arrays):
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        req = urllib.request.Request(self.base + path, data=buf.getvalue(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()


@pytest.mark.parametrize("batch", [False, True])
def test_gaze_kind_over_http(late_checkpoint, batch):
    path, _ = late_checkpoint
    a, b = _pairs(3, 5)
    want = GazePredictor.from_checkpoint(path, device=CPU, batch_buckets=(1, 4)).predict(a, b)
    argv = ["--checkpoint", str(path), "--device", "cpu", "--port", "0", "--buckets", "1,4"]
    with _Server(*argv, *(["--dynamic-batch"] if batch else [])) as s:
        assert s.get("/healthz") == {"status": "ok", "kind": "gaze"}
        info = s.get("/info")
        assert info["inputs"] == ["img1", "img2"]
        assert info["input_spec"]["img1"] == ["N", 3, IMG, IMG]
        status, body = s.post("/predict", img1=a, img2=b)
        assert status == 200
        got = json.loads(body)
        np.testing.assert_array_equal(np.asarray(got["logits"], np.float32), want["logits"])
        assert got["labels"] == want["labels"]
        status, body = s.post("/predict?format=npz", img1=a[:1], img2=b[:1])
        assert status == 200
        npz = np.load(io.BytesIO(body))
        np.testing.assert_array_equal(npz["logits"], want["logits"][:1])
        status, body = s.post("/predict", img1=a[:, :, :16], img2=b[:, :, :16])
        assert status == 400 and b"does not match" in body
        status, body = s.post("/predict", img1=a)
        assert status == 400 and b"img2" in body
        assert s.get("/metrics")["requests"] == 2


def test_sniff_gaze_kind(late_checkpoint, tmp_path):
    path, _ = late_checkpoint
    assert serve.sniff_kind(path) == "gaze"
    bare = tmp_path / "bare.pt"
    bare.write_bytes(path.read_bytes())  # no meta: the encoder. prefix
    assert serve.sniff_kind(bare) == "gaze"
    early = tmp_path / "early.pt"
    _checkpoint(early, "early", "add", None)
    assert serve.sniff_kind(early) == "gaze"
