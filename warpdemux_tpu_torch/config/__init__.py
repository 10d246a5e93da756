"""JAX-free signal-processing configuration."""

from warpdemux_tpu_torch.config.sig_proc import SigProcConfig
from warpdemux_tpu_torch.config.config import (
    Config,
    InputConfig,
    OutputConfig,
    BatchConfig,
    TaskConfig,
)
from warpdemux_tpu_torch.config.utils import (
    load_chemistry_config,
    get_model_spc_config,
    apply_overrides,
)
