"""Training: the dataset and loaders, the on-card augmentation, the detection
loss, optimizer and EMA, the train step and the Trainer."""

from .loss import LossConfig, detection_loss  # noqa: F401
from .optimizer import OptimizerConfig  # noqa: F401
from .trainer import TrainConfig, Trainer, TrainState, bucket_gt, train_run  # noqa: F401
