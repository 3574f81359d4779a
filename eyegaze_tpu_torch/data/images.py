"""Real gaze-image ingestion: JPG decode, resize, conversion to arrays
(numpy; PIL only inside ``load_image``).

The port's copy of ``eyegaze_tpu/data/images.py``: the reference's PIL
pipeline (``gaze_pair_dataset.py:66-110``: ``Image.open(...).convert('RGB')``
-> ``T.Resize((224, 224))`` -> ``ToTensor``) with the path
``image_root / f"{player}{ext}"``.  torchvision resizes the uint8 PIL image
before dividing by 255, so the resized uint8 pixels stored here are the
reference's tensors exactly; ``to_unit_float`` and the normalization run on
the device (``data/image_fusion.py``).

Decode and resize happen once (``python -m
eyegaze_tpu_torch.convert_gaze_images`` -> memmap-able ``.npy`` arrays);
training slices numpy and ships uint8 to the card.  A sample that fails to
load is recorded and replaced by zero images, as the reference's dummy
sample (``multimodal_dataset.py:243-258``).

PIL is imported inside ``load_image`` alone, so nothing else needs it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from eyegaze_tpu_torch.data.loader import GazePairArrays
from eyegaze_tpu_torch.data.metadata import LABEL2ID


def load_image(path: str | Path, size: int = 224) -> np.ndarray:
    """Decode one image -> (3, size, size) uint8, RGB: PIL's bilinear resize
    of the uint8 pixels, which is torchvision's ``T.Resize((s, s))`` on a PIL
    image."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        arr = np.asarray(im, np.uint8)
    return np.transpose(arr, (2, 0, 1))


def image_path(image_root: str | Path, player: str, extension: str = ".jpg") -> Path:
    return Path(image_root) / f"{player}{extension}"


def convert_gaze_images(
    metadata: Sequence[Dict],
    image_root: str | Path,
    out_dir: str | Path,
    size: int = 224,
    extension: str = ".jpg",
    log_every: int = 200,
) -> Dict:
    """One-time JPG -> array conversion of the whole metadata.

    Writes to ``out_dir``: ``img1.npy``/``img2.npy`` uint8 (N, 3, size, size),
    ``label.npy`` and ``pair.npy`` int32, and ``meta.json`` (size, failures,
    record order), which it also returns.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    n = len(metadata)
    img1 = np.lib.format.open_memmap(
        out / "img1.npy", mode="w+", dtype=np.uint8, shape=(n, 3, size, size)
    )
    img2 = np.lib.format.open_memmap(
        out / "img2.npy", mode="w+", dtype=np.uint8, shape=(n, 3, size, size)
    )
    labels = np.zeros(n, np.int32)
    pairs = np.zeros(n, np.int32)
    failures: List[Dict] = []
    for i, rec in enumerate(metadata):
        labels[i] = LABEL2ID[rec["class"]]
        pairs[i] = int(rec["pair"])
        for field, dst in (("player1", img1), ("player2", img2)):
            p = image_path(image_root, rec[field], extension)
            try:
                dst[i] = load_image(p, size)
            except Exception as e:  # noqa: BLE001 — recorded and zero-filled; the run goes on
                failures.append({"index": i, "path": str(p), "error": str(e)})
                dst[i] = 0
        if log_every and (i + 1) % log_every == 0:
            print(f"[convert] {i + 1}/{n}")
    img1.flush()
    img2.flush()
    np.save(out / "label.npy", labels)
    np.save(out / "pair.npy", pairs)
    meta = {
        "num_records": n,
        "size": size,
        "extension": extension,
        "num_failures": len(failures),
        "failures": failures[:50],
        "players": [[m["player1"], m["player2"]] for m in metadata],
    }
    with open(out / "meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_converted_gaze(
    out_dir: str | Path, mmap: bool = True, indices: Optional[np.ndarray] = None
) -> GazePairArrays:
    """A converted directory back as ``GazePairArrays`` (uint8 images)."""
    out = Path(out_dir)
    mode = "r" if mmap else None
    img1 = np.load(out / "img1.npy", mmap_mode=mode)
    img2 = np.load(out / "img2.npy", mmap_mode=mode)
    labels = np.load(out / "label.npy")
    pairs = np.load(out / "pair.npy")
    if indices is not None:
        img1, img2 = img1[indices], img2[indices]
        labels, pairs = labels[indices], pairs[indices]
    return GazePairArrays(img1=img1, img2=img2, labels=labels, pairs=pairs)


def load_gaze_pairs(
    metadata: Sequence[Dict],
    image_root: str | Path,
    size: int = 224,
    extension: str = ".jpg",
) -> GazePairArrays:
    """A (small) metadata list decoded straight into memory, without a
    conversion directory."""
    n = len(metadata)
    img1 = np.zeros((n, 3, size, size), np.uint8)
    img2 = np.zeros((n, 3, size, size), np.uint8)
    labels = np.zeros(n, np.int32)
    pairs = np.zeros(n, np.int32)
    for i, rec in enumerate(metadata):
        labels[i] = LABEL2ID[rec["class"]]
        pairs[i] = int(rec["pair"])
        img1[i] = load_image(image_path(image_root, rec["player1"], extension), size)
        img2[i] = load_image(image_path(image_root, rec["player2"], extension), size)
    return GazePairArrays(img1=img1, img2=img2, labels=labels, pairs=pairs)
