"""Training: the alternating G/D step, its state and optimizers, the
Experiment (train and eval loops), and the separation and eval graphs."""

from gan_sass_tf_tpu_torch.train.experiment import Experiment
from gan_sass_tf_tpu_torch.train.state import (
    ClippedAdam,
    TrainState,
    create_train_state,
    load_train_state,
    make_optimizers,
)
from gan_sass_tf_tpu_torch.train.step import (
    build_eval_step,
    build_separate_fn,
    build_train_step,
)

__all__ = [
    "Experiment", "ClippedAdam", "TrainState", "create_train_state",
    "load_train_state", "make_optimizers", "build_eval_step",
    "build_separate_fn", "build_train_step",
]
