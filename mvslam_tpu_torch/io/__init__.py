"""Host-side IO: images and manifests, the native (libjpeg) prefetching
loader; checkpoints in ``mvslam_tpu_torch.io.checkpoint`` (imported by
name: it pulls in the front end)."""

from mvslam_tpu_torch.io.image import (  # noqa: F401
    iter_directory as iter_directory,
    load_image_grayscale as load_image_grayscale,
    load_image_rgb as load_image_rgb,
    read_manifest as read_manifest,
    save_image as save_image,
    write_manifest as write_manifest,
)
from mvslam_tpu_torch.io import native_loader as native_loader  # noqa: F401
