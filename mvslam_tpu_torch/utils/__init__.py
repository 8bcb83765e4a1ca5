"""Host-side utilities: logging, synchronisation primitives, strings,
directory listing, timing (host clock and the card's), the synthetic
scene renderer, error codes."""

from mvslam_tpu_torch.utils.logging import Logger as Logger, Logging as Logging  # noqa: F401
from mvslam_tpu_torch.utils.sync import (  # noqa: F401
    Event as Event,
    Lock as Lock,
    Mutex as Mutex,
)
