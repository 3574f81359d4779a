"""Real gaze-image ingestion and metadata in the port against the JAX package.

- ``load_image`` on small JPGs and PNGs that PIL writes here, equal to the
  bit to JAX's ``load_image`` (the same PIL decode and bilinear resize).
- ``convert_gaze_images`` -> ``load_converted_gaze`` and
  ``load_gaze_pairs`` round trips: the same arrays and meta as JAX's, a
  missing file recorded and zero-filled in both, and ``python -m
  eyegaze_tpu_torch.convert_gaze_images`` writing the same arrays.
- The metadata functions (``get_class_from_filename``,
  ``generate_metadata``, ``load_metadata``, ``verify_metadata``) against
  JAX's on ``synthetic_metadata`` and on records with every fault they
  screen for.
- ``train_gaze --images`` (converted arrays) and ``--image-root`` +
  ``--metadata`` (JPGs decoded directly): the validation pairs are JAX's
  ``load_gaze_pairs`` of the held-out pairs, and an epoch trains.

The file skips where PIL is not installed: only ``data/images.py`` needs it.
"""

import json

import numpy as np
import pytest

pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

from eyegaze_tpu.data import images as jax_images  # noqa: E402
from eyegaze_tpu.data import metadata as jax_metadata  # noqa: E402
from eyegaze_tpu_torch import convert_gaze_images as convert_entry  # noqa: E402
from eyegaze_tpu_torch.data import images, metadata, synthetic  # noqa: E402

SIZE = 24


def _write_images(root, records, seed=0):
    """A small RGB JPG of its own size for every player."""
    r = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i, rec in enumerate(records):
        for field in ("player1", "player2"):
            h, w = 30 + 7 * i, 41 + 3 * i
            pixels = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(pixels).save(root / f"{rec[field]}.jpg", quality=90)
    return root


def test_load_image_equals_jax(tmp_path):
    r = np.random.default_rng(1)
    for name, mode, shape in (("a.jpg", "RGB", (37, 53, 3)), ("b.png", "L", (20, 31)),
                              ("c.png", "RGBA", (64, 48, 4))):
        path = tmp_path / name
        Image.fromarray(r.integers(0, 256, shape, dtype=np.uint8), mode).save(path)
        got = images.load_image(path, SIZE)
        assert got.shape == (3, SIZE, SIZE) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_images.load_image(path, SIZE), err_msg=name)
    assert images.image_path(tmp_path, "p12_a") == jax_images.image_path(tmp_path, "p12_a")


def test_convert_and_load_round_trips_equal_jax(tmp_path):
    records = synthetic.synthetic_metadata(5, seed=2)
    root = _write_images(tmp_path / "jpg", records)
    (root / f"{records[3]['player2']}.jpg").unlink()  # one missing file
    got_meta = images.convert_gaze_images(records, root, tmp_path / "port", size=SIZE)
    want_meta = jax_images.convert_gaze_images(records, root, tmp_path / "jax", size=SIZE)
    assert got_meta["num_failures"] == want_meta["num_failures"] == 1
    assert got_meta["failures"][0]["index"] == 3
    assert {k: v for k, v in got_meta.items() if k != "failures"} == \
        {k: v for k, v in want_meta.items() if k != "failures"}
    for name in ("img1", "img2", "label", "pair"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{name}.npy"),
                                      np.load(tmp_path / "jax" / f"{name}.npy"), err_msg=name)
    assert json.loads((tmp_path / "port" / "meta.json").read_text())["size"] == SIZE

    got = images.load_converted_gaze(tmp_path / "port", indices=np.array([4, 0]))
    want = jax_images.load_converted_gaze(tmp_path / "jax", indices=np.array([4, 0]))
    for field in ("img1", "img2", "labels", "pairs"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    full = images.load_converted_gaze(tmp_path / "port", mmap=False)
    assert len(full) == 5 and not full.img2[3].any()
    ds = full.as_dataset()
    assert set(ds.arrays) == {"img1", "img2", "label", "pair"} and len(ds) == 5

    kept = [rec for i, rec in enumerate(records) if i != 3]
    got = images.load_gaze_pairs(kept, root, size=SIZE)
    want = jax_images.load_gaze_pairs(kept, root, size=SIZE)
    for field in ("img1", "img2", "labels", "pairs"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    with pytest.raises(FileNotFoundError):
        images.load_gaze_pairs(records, root, size=SIZE)


def test_convert_entry_point(tmp_path, capsys):
    records = synthetic.synthetic_metadata(3, seed=4)
    root = _write_images(tmp_path / "jpg", records, seed=4)
    meta_path = tmp_path / "complete_metadata.json"
    meta_path.write_text(json.dumps(records))
    meta = convert_entry.main(["--metadata", str(meta_path), "--image-root", str(root),
                               "--output", str(tmp_path / "out"), "--size", str(SIZE)])
    assert meta["num_failures"] == 0 and "[done] wrote 3 trials" in capsys.readouterr().out
    want = jax_images.load_gaze_pairs(records, root, size=SIZE)
    got = images.load_converted_gaze(tmp_path / "out")
    np.testing.assert_array_equal(got.img1, want.img1)
    np.testing.assert_array_equal(got.labels, want.labels)


def test_metadata_functions_equal_jax(tmp_path):
    records = synthetic.synthetic_metadata(40, seed=3)
    raw = records + [
        {"pair": 18, "player1": "p18_a_single", "player2": "p18_b_single"},  # excluded
        {"pair": 41, "player1": "p41_a_coop", "player2": "p41_b_coop"},  # out of range
        {"pair": 20, "player1": "p20_a_coop_7", "player2": "p20_b_coop_7"},  # class from name
        {"pair": 21, "player1": "p21_a_comp", "player2": "p21_b", "class": "Comp"},  # unknown
        {"pair": 22, "player1": "p22_a_nothing", "player2": "p22_b"},  # no class at all
    ]
    for name in ("x_Single_3", "COMPETITION", "p1_coop", "none", "compcoop"):
        assert metadata.get_class_from_filename(name) == \
            jax_metadata.get_class_from_filename(name)
    got = metadata.generate_metadata(raw)
    assert got == jax_metadata.generate_metadata(raw)
    assert len(got) == 41 and got[-1]["class"] == "Cooperation"
    path = tmp_path / "complete_metadata.json"
    path.write_text(json.dumps(got))
    assert metadata.load_metadata(path) == jax_metadata.load_metadata(path)
    faulty = records + [
        {"pair": 18, "player1": "a", "player2": "b", "class": "Single"},
        {"pair": 50, "player1": "a", "player2": "b", "class": "Single"},
        {"pair": 13, "player1": None, "player2": "b", "class": "Single"},
        {"pair": 14, "player1": "a", "player2": "b", "class": "Comp"},
    ]
    for recs in (got, faulty):
        assert metadata.verify_metadata(recs) == jax_metadata.verify_metadata(recs)
    assert metadata.verify_metadata(got)["ok"]
    assert len(metadata.verify_metadata(faulty)["problems"]) == 4


@pytest.mark.parametrize("source", ["images", "image-root"])
def test_train_gaze_reads_real_images(tmp_path, source):
    """``train_gaze --images`` (converted arrays) and ``--image-root`` +
    ``--metadata`` (JPGs decoded directly) train on the same uint8 pairs."""
    import yaml

    from eyegaze_tpu_torch import train_gaze

    records = synthetic.synthetic_metadata(30, seed=6)  # pairs 33-40 among them
    root = _write_images(tmp_path / "jpg", records, seed=6)
    meta_path = tmp_path / "complete_metadata.json"
    meta_path.write_text(json.dumps(records))
    config = tmp_path / "tiny.yaml"
    config.write_text(yaml.safe_dump({
        "training": {"output_dir": str(tmp_path / "run"), "num_train_epochs": 1,
                     "per_device_train_batch_size": 4, "per_device_eval_batch_size": 4,
                     "bf16": False}, "system": {"seed": 0}}))
    argv = ["--config", str(config), "--model", "late", "--tiny", "--device", "cpu"]
    if source == "images":
        images.convert_gaze_images(records, root, tmp_path / "arrays", size=64)
        argv += ["--images", str(tmp_path / "arrays")]
    else:
        argv += ["--image-root", str(root), "--metadata", str(meta_path)]
    result = train_gaze.main(argv)
    val = result["val"]
    want = jax_images.load_gaze_pairs([r for r in records if r["pair"] >= 33], root, size=64)
    np.testing.assert_array_equal(val.arrays["img1"], want.img1)
    np.testing.assert_array_equal(val.arrays["label"], want.labels)
    assert result["trainer"].optimizer.count == (30 - len(val)) // 4
    assert "val/f1_macro" in result["history"][0]
