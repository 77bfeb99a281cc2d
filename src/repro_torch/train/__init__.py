"""Training of the port: AdamW (``optimizer``), atomic checkpoints
(``checkpoint``), compressed gradient all-reduce (``compression``) and the
fault-tolerant loop (``trainer``)."""

from repro_torch.train import checkpoint, compression, optimizer, trainer
from repro_torch.train.optimizer import OptimizerConfig, adamw_update, init_opt_state
from repro_torch.train.trainer import TrainerConfig, make_train_step, train
