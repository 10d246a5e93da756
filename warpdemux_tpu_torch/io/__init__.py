"""Host I/O: the pod5 reader and its VBZ signal codec (numpy), and the
CSV writers. pyarrow and zstandard are imported by the functions that
read or decode, not here."""

from warpdemux_tpu_torch.io.pod5 import Pod5Reader, yield_signal_batches
from warpdemux_tpu_torch.io.writers import (
    save_predictions,
    save_fingerprints,
    save_boundaries,
)
