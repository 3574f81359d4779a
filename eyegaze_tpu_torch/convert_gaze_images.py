"""One-time gaze-image conversion: JPG directory + metadata -> array shards.

The counterpart of ``scripts/convert_gaze_images.py``:

    python -m eyegaze_tpu_torch.convert_gaze_images --metadata complete_metadata.json \
        --image-root /data/gaze_images --output runs/gaze_arrays [--size 224] [--extension .jpg]

Decodes and resizes every player's JPG once and stores uint8 ``.npy``
arrays, which ``python -m eyegaze_tpu_torch.train_gaze --images`` reads.
It needs PIL; it runs on the host alone.
"""

from __future__ import annotations

import argparse
import json

from eyegaze_tpu_torch.data.images import convert_gaze_images
from eyegaze_tpu_torch.data.metadata import load_metadata, verify_metadata


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--metadata", required=True, help="complete_metadata.json")
    ap.add_argument("--image-root", required=True, help="directory of per-player JPGs")
    ap.add_argument("--output", required=True, help="output array directory")
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--extension", default=".jpg")
    args = ap.parse_args(argv)

    metadata = load_metadata(args.metadata)
    report = verify_metadata(metadata)
    print(f"[metadata] {report['num_records']} records, "
          f"classes {report['class_counts']}, ok={report['ok']}")
    meta = convert_gaze_images(metadata, args.image_root, args.output, size=args.size,
                               extension=args.extension)
    print(json.dumps({k: v for k, v in meta.items() if k != "players"}, indent=1))
    if meta["num_failures"]:
        print(f"[warn] {meta['num_failures']} images failed to load "
              f"(zero-filled; see {args.output}/meta.json)")
    print(f"[done] wrote {meta['num_records']} trials to {args.output}")
    return meta


if __name__ == "__main__":
    main()
