"""Helpers outside the decision path: synthetic reads."""

from warpdemux_tpu_torch.utils import synthetic  # noqa: F401
