"""Adapter / poly(A) boundary detection."""

from warpdemux_tpu_torch.detect.containers import (
    DetectArrays,
    FAIL_REASONS,
    fail_code_to_reason,
)
from warpdemux_tpu_torch.detect.boundaries import detect_boundaries_batch
