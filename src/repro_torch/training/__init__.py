from repro_torch.training.optimizer import OptimizerConfig, make_optimizer
from repro_torch.training.train_step import make_train_step
from repro_torch.training.data import batch_for_step
from repro_torch.training import checkpoint
