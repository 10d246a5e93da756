"""Batched tensor ops of the decision step; kernels dispatch by device.

The names the JAX package's `warpdemux_tpu.ops` exports, each the port's
counterpart; `normalize` is the function (as there), not the submodule."""

from warpdemux_tpu_torch.ops.normalize import (
    masked_mean_std,
    masked_median,
    masked_mad,
    mean_normalize,
    mad_normalize,
    normalize,
    normalize_wrt,
    clip_outliers,
)
from warpdemux_tpu_torch.ops.segmentation import (
    windowed_t_test,
    segment_means,
    segment_signal_batch,
)
from warpdemux_tpu_torch.ops.peaks import find_peaks_batch, select_top_peaks
from warpdemux_tpu_torch.ops.dtw import (
    distance_matrix_to,
    dtw_distance_matrix,
    dtw_distance_matrix_ref,
    dtw_distance_ref,
)
