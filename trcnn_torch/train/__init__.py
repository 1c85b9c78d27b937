"""Training: Caffe-order optimizer, train step, trainer (port of
``trcnn/train``)."""

from trcnn_torch.train.optim import CaffeSGD, learning_rate  # noqa: F401
from trcnn_torch.train.step import TrainState, step_generator, train_step  # noqa: F401
from trcnn_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
