"""The yolo11 training step: detection loss, optimizer and schedules, EMA."""

from .loss import LossConfig, detection_loss  # noqa: F401
from .optimizer import OptimizerConfig  # noqa: F401
from .trainer import TrainConfig, TrainState, bucket_gt  # noqa: F401
