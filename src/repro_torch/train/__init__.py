from repro_torch.train.optimizer import adamw, adafactor, make_optimizer  # noqa
from repro_torch.train.trainstep import TrainState, make_train_step, init_state  # noqa
from repro_torch.train.trainer import Trainer  # noqa
