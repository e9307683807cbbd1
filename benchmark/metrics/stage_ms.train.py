"""stage_ms.train: host milliseconds of ``StepProgram.stage`` (the index
copy, the augmentation draws and the hyperparameter row), the mean
``train.stage`` span of the program's timeline in the traced window."""

from benchmark.lib import phases


def read(ctx):
    return phases.mean_span_ms(ctx.tr, "train.stage")
