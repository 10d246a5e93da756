"""The fused per-minibatch decision step and the offline run."""

from warpdemux_tpu_torch.pipeline.step import make_demux_step, DemuxStepOutput
from warpdemux_tpu_torch.pipeline.run import run_demux
