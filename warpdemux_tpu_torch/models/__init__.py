"""Model registry and the classifiers (DTW-SVM, DTW-MLP, Fpt-Boost)."""

from warpdemux_tpu_torch.models.registry import (
    available_models,
    load_model,
    model_config,
)
from warpdemux_tpu_torch.models.dtw_svm import DTWSVMModel
from warpdemux_tpu_torch.models.dtw_mlp import DTWMLPModel
from warpdemux_tpu_torch.models.fpt_boost import FptBoostModel
