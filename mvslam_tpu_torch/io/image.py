"""Host-side image IO and dataset manifests (port of
``mvslam_tpu.io.image``).

Decoding happens on the host (PIL, imported inside the functions that need
it); images are float32 CPU tensors in [0, 1], which the caller moves to
its device. Manifests are ``image.txt`` lists, one path per line.
"""

from __future__ import annotations

import os
from typing import Iterator, List

import numpy as np
import torch

Tensor = torch.Tensor


def load_image_grayscale(path: str, dtype=torch.float32) -> Tensor:
    """(H, W) grayscale in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("L"), dtype=np.float32) / 255.0
    return torch.from_numpy(arr).to(dtype)


def load_image_rgb(path: str, dtype=torch.float32) -> Tensor:
    """(H, W, 3) RGB in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return torch.from_numpy(arr).to(dtype)


def save_image(path: str, img) -> None:
    """Save [0, 1] float image (grayscale or RGB; tensor or array) via
    PIL."""
    from PIL import Image

    if isinstance(img, Tensor):
        img = img.detach().cpu().numpy()
    arr = np.clip(np.asarray(img, dtype=np.float32), 0.0, 1.0)
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def iter_directory(path: str, extension: str | None = None) -> Iterator[str]:
    """Filenames in a directory filtered by extension, sorted (so replays
    are deterministic)."""
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if not os.path.isfile(full):
            continue
        if extension is None or name.lower().endswith(extension.lower()):
            yield full


def read_manifest(manifest_path: str) -> List[str]:
    """``image.txt`` replay manifest: one image path per line, relative
    paths resolved against the manifest's directory."""
    base = os.path.dirname(os.path.abspath(manifest_path))
    out = []
    with open(manifest_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append(
                line if os.path.isabs(line)
                else os.path.normpath(os.path.join(base, line))
            )
    return out


def write_manifest(manifest_path: str, paths: List[str]) -> None:
    base = os.path.dirname(os.path.abspath(manifest_path))
    with open(manifest_path, "w") as f:
        for p in paths:
            rel = os.path.relpath(os.path.abspath(p), base)
            f.write(rel + "\n")
