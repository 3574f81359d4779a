"""The port's dynamic batcher and its HTTP front end, on the CPU.

``DynamicBatcher`` (``eyegaze_tpu_torch.serving``) coalesces concurrent
requests and hands each caller its own rows, ``labels`` included (the JAX
batcher slices each label string instead of the list); it isolates
incompatible and failing requests, and keeps ``dispatches ==
len(dispatch_rows)`` when a coalesced dispatch fails.

``python -m eyegaze_tpu_torch.serve`` is driven through its ``main`` on
127.0.0.1, port 0, with ``--device cpu``, on checkpoints written as the
export script writes them (a state_dict plus ``.meta.json``), for the kinds
``eeg`` and ``art``.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from eyegaze_tpu_torch import serve
from eyegaze_tpu_torch.models.art import ArtConfig, ArtifactRemovalTransformer
from eyegaze_tpu_torch.models.dual_eeg import DualEEGTransformer
from eyegaze_tpu_torch.serving import ArtDenoiser, DynamicBatcher, Predictor, _rows

C, T = 8, 256
EEG_MODEL = {"in_channels": C, "num_labels": 3, "d_model": 32, "num_layers": 1, "num_heads": 4,
             "d_ff": 64, "conv_kernel_size": 7}
ART_MODEL = {"in_channels": C, "out_channels": C, "embedding_size": 32, "num_encoder_layers": 1,
             "num_decoder_layers": 1, "num_heads": 4, "feedforward_size": 64, "max_len": T}
CPU = torch.device("cpu")
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eeg_model(dtype=torch.float32):
    return DualEEGTransformer(
        **{k: v for k, v in EEG_MODEL.items() if k != "num_labels"}, max_len=128,
        device=CPU, dtype=dtype, generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def eeg_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("eeg") / "model.pt"
    torch.save(_eeg_model().state_dict(), path)
    path.with_suffix(".meta.json").write_text(json.dumps({"config": {
        "model": EEG_MODEL, "data": {"sampling_rate": 256.0}}}))
    return path


@pytest.fixture(scope="module")
def art_checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("art") / "model.pt"
    model = ArtifactRemovalTransformer(ArtConfig(**ART_MODEL), device=CPU,
                                       generator=torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), path)
    path.with_suffix(".meta.json").write_text(json.dumps({"config": {"model": ART_MODEL}}))
    return path


def _eeg(seed, n):
    r = np.random.default_rng(seed)
    return [r.normal(size=(n, C, T)).astype(np.float32) for _ in range(2)]


def _concurrently(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


# -- DynamicBatcher -------------------------------------------------------

def test_rows_slices_label_lists_as_lists():
    out = {"logits": np.arange(6.0).reshape(3, 2), "labels": ["Single", "Competition",
                                                              "Cooperation"]}
    got = _rows(out, 1, 1)
    assert got["labels"] == ["Competition"]
    np.testing.assert_array_equal(got["logits"], [[2.0, 3.0]])
    with pytest.raises(TypeError):
        _rows({"x": 3.0}, 0, 1)


def test_dynamic_batcher_coalesces_and_returns_each_caller_its_rows():
    """Concurrent single-row requests share dispatches, and each gets the
    rows a direct ``predict`` gives, labels included: whole strings, one
    per row.  One bucket, so every dispatch runs the same padded shape and
    the rows agree to the bit."""
    pred = Predictor(_eeg_model(), device=CPU, batch_buckets=(8,), preprocess=False)
    e1, e2 = _eeg(43, 6)
    want = pred.predict(e1, e2)
    batcher = DynamicBatcher(pred, max_wait_ms=500.0)
    try:
        outs = [None] * 6

        def one(i):
            outs[i] = batcher.predict(e1[i:i + 1], e2[i:i + 1])

        _concurrently(one, 6)
        for i, out in enumerate(outs):
            assert out is not None, f"request {i} never completed"
            for k in ("logits", "probs", "preds"):
                np.testing.assert_array_equal(out[k], want[k][i:i + 1], err_msg=k)
            assert out["labels"] == want["labels"][i:i + 1]
        stats = batcher.stats
        assert stats["requests"] == 6 and stats["dispatches"] < 6
        assert stats["max_coalesced"] >= 2
        assert len(stats["dispatch_rows"]) == stats["dispatches"]
        assert sum(stats["dispatch_rows"]) == 6
        assert len(stats["queue_wait_ms"]) == len(stats["exec_ms"]) == 6
        assert min(stats["queue_wait_ms"]) >= 0.0 and min(stats["exec_ms"]) > 0.0
        summary = batcher.phase_summary()
        for k in ("queue_wait_ms", "exec_ms"):
            assert summary[k]["p50"] <= summary[k]["p99"] <= summary[k]["max"]
        public = batcher.public_stats()
        assert not any(isinstance(v, list) for v in public.values())
        assert public["phase_breakdown"] == summary
    finally:
        batcher.close()
    assert not batcher._thread.is_alive()


class _RefusesNaN:
    """A predictor that fails any batch holding a NaN, so a coalesced batch
    with one bad member fails as a whole."""

    def __init__(self, pred):
        self.pred, self.buckets = pred, pred.buckets

    def predict(self, e1, e2):
        if np.isnan(e1).any():
            raise ValueError("NaN in the request")
        return self.pred.predict(e1, e2)


def _race(batcher, requests):
    results = {}

    def call(i):
        name, arrays = requests[i]
        try:
            results[name] = batcher.predict(*arrays)
        except Exception as e:  # noqa: BLE001 — the test reads it
            results[name] = e

    _concurrently(call, len(requests))
    return results


def test_dynamic_batcher_isolates_incompatible_requests():
    pred = Predictor(_eeg_model(), device=CPU, batch_buckets=(2, 8), preprocess=False)
    good = _eeg(47, 1)
    bad = [np.zeros((1, C + 1, T), np.float32)] * 2  # the wrong channel count
    want = pred.predict(*good)
    batcher = DynamicBatcher(pred, max_wait_ms=500.0)
    try:
        results = _race(batcher, [("good", good), ("bad", bad)])
    finally:
        batcher.close()
    assert isinstance(results["bad"], RuntimeError)
    np.testing.assert_array_equal(results["good"]["logits"], want["logits"])
    assert batcher.stats["dispatches"] == len(batcher.stats["dispatch_rows"]) == 2


def test_dynamic_batcher_retries_a_failed_group_member_by_member():
    """A coalesced dispatch that fails is retried one request at a time: the
    good request gets its rows, the bad one its error, and the failed
    attempt is a dispatch with its rows recorded."""
    pred = Predictor(_eeg_model(), device=CPU, batch_buckets=(2, 8), preprocess=False)
    good = _eeg(48, 1)
    nan = _eeg(49, 1)
    nan[0][0, 0, 0] = np.nan
    want = pred.predict(*good)
    batcher = DynamicBatcher(_RefusesNaN(pred), max_wait_ms=500.0)
    try:
        results = _race(batcher, [("good", good), ("nan", nan)])
    finally:
        batcher.close()
    assert isinstance(results["nan"], ValueError)
    np.testing.assert_array_equal(results["good"]["logits"], want["logits"])
    stats = batcher.stats
    assert stats["requests"] == 2 and stats["max_coalesced"] == 2
    assert stats["dispatches"] == len(stats["dispatch_rows"]) == 3
    assert stats["dispatch_rows"] == [2, 1, 1]
    assert len(stats["queue_wait_ms"]) == len(stats["exec_ms"]) == 2


# -- HTTP ------------------------------------------------------------------

class _Server:
    """``serve.main(argv)`` in a thread; stops it on exit."""

    def __init__(self, *argv):
        bound = []
        self.thread = threading.Thread(target=serve.main, args=(list(argv), bound.append),
                                       daemon=True)
        self.thread.start()
        for _ in range(TIMEOUT * 10):
            if bound or not self.thread.is_alive():
                break
            self.thread.join(0.1)
        assert bound, "the server did not start"
        self.server = bound[0]
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.thread.join(TIMEOUT)
        assert not self.thread.is_alive()

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=TIMEOUT) as resp:
            return json.load(resp)

    def post(self, path, **arrays):
        """(status, body bytes) of a POST of ``arrays`` as an npz."""
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        req = urllib.request.Request(self.base + path, data=buf.getvalue(), method="POST")
        try:
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()


def test_http_serves_eeg(eeg_checkpoint):
    e1, e2 = _eeg(51, 3)
    want = Predictor.from_checkpoint(eeg_checkpoint, device=CPU,
                                     batch_buckets=(2, 4)).predict(e1, e2)
    assert serve.sniff_kind(eeg_checkpoint) == "eeg"
    with _Server("--checkpoint", str(eeg_checkpoint), "--device", "cpu", "--port", "0",
                 "--buckets", "2,4") as s:
        assert s.get("/healthz") == {"status": "ok", "kind": "eeg"}
        info = s.get("/info")
        assert info["inputs"] == ["eeg1", "eeg2"] and info["batch_buckets"] == [2, 4]
        assert info["input_spec"]["eeg1"] == ["N", C, "T"] and info["device"] == "cpu"
        status, body = s.post("/predict", eeg1=e1, eeg2=e2)
        assert status == 200
        got = json.loads(body)
        np.testing.assert_array_equal(np.asarray(got["logits"], np.float32), want["logits"])
        assert got["labels"] == want["labels"]
        status, body = s.post("/predict?format=npz", eeg1=e1, eeg2=e2)
        assert status == 200
        npz = np.load(io.BytesIO(body))
        np.testing.assert_array_equal(npz["probs"], want["probs"])
        assert list(npz["labels"]) == want["labels"]
        status, body = s.post("/predict", eeg1=e1)
        assert status == 400 and "missing input arrays ['eeg2']" in json.loads(body)["error"]
        status, _ = s.post("/predict", eeg1=e1[:, :4], eeg2=e2[:, :4])  # 4 channels, not 8
        assert status == 400
        metrics = s.get("/metrics")
        assert metrics["requests"] == 2 and metrics["errors"] == 0
        assert metrics["latency_p50_ms"] <= metrics["latency_p99_ms"]


def test_http_serves_art(art_checkpoint):
    noisy = np.random.default_rng(52).normal(size=(3, C, T)).astype(np.float32)
    want = ArtDenoiser.from_checkpoint(art_checkpoint, device=CPU,
                                       batch_buckets=(2, 4)).predict(noisy)["denoised"]
    assert serve.sniff_kind(art_checkpoint) == "art"
    with _Server("--checkpoint", str(art_checkpoint), "--device", "cpu", "--port", "0",
                 "--buckets", "2,4", "--no-warmup") as s:
        info = s.get("/info")
        assert info["kind"] == "art" and info["input_spec"]["noisy"] == ["N", C, f"T<={T}"]
        status, body = s.post("/predict?format=npz", noisy=noisy)
        assert status == 200
        np.testing.assert_array_equal(np.load(io.BytesIO(body))["denoised"], want)
        status, body = s.post("/predict", noisy=noisy)
        assert status == 200
        np.testing.assert_array_equal(np.asarray(json.loads(body)["denoised"], np.float32), want)
        status, _ = s.post("/predict", eeg1=noisy)
        assert status == 400


def test_http_dynamic_batch(eeg_checkpoint):
    """``--dynamic-batch``: concurrent single-trial posts share dispatches and
    each gets its own rows, labels included.  One bucket, so the rows agree
    to the bit with a direct ``predict``."""
    e1, e2 = _eeg(53, 4)
    want = Predictor.from_checkpoint(eeg_checkpoint, device=CPU,
                                     batch_buckets=(8,)).predict(e1, e2)
    with _Server("--checkpoint", str(eeg_checkpoint), "--device", "cpu", "--port", "0",
                 "--buckets", "8", "--dynamic-batch", "500") as s:
        results = [None] * 4

        def post_one(i):
            status, body = s.post("/predict", eeg1=e1[i:i + 1], eeg2=e2[i:i + 1])
            results[i] = (status, json.loads(body))

        _concurrently(post_one, 4)
        for i, (status, got) in enumerate(results):
            assert status == 200
            np.testing.assert_array_equal(np.asarray(got["logits"], np.float32),
                                          want["logits"][i:i + 1])
            assert got["labels"] == want["labels"][i:i + 1]
        batch = s.get("/metrics")["dynamic_batch"]
        assert batch["requests"] == 4 and batch["dispatches"] < 4
        assert s.get("/info")["dynamic_batch"]["max_wait_ms"] == 500.0


def test_sniff_kind_without_meta(eeg_checkpoint, art_checkpoint, tmp_path):
    for src, kind in ((eeg_checkpoint, "eeg"), (art_checkpoint, "art")):
        bare = tmp_path / f"{kind}.pt"
        bare.write_bytes(src.read_bytes())
        assert serve.sniff_kind(bare) == kind
    other = tmp_path / "other.pt"
    torch.save({"backbone.weight": torch.zeros(1)}, other)
    with pytest.raises(SystemExit, match="pass --kind"):
        serve.sniff_kind(other)


@pytest.mark.parametrize("kind", ["multimodal", "hypereeg"])
def test_unported_kind_is_refused(eeg_checkpoint, kind):
    """Every kind of the JAX package is served now (``NOT_PORTED`` is
    empty); the multimodal and hypereeg kinds refuse an EEG checkpoint by
    its keys."""
    assert serve.NOT_PORTED == ()
    argv = ["--checkpoint", str(eeg_checkpoint), "--kind", kind, "--device", "cpu"]
    with pytest.raises(ValueError, match=f"not a {kind} state_dict"):
        serve.main(argv)
