from repro_torch.train.step import (  # noqa: F401
    TrainState, init_train_state, make_train_step,
)
from repro_torch.train.checkpoint import (  # noqa: F401
    latest_checkpoint, load_checkpoint, save_checkpoint,
)
from repro_torch.train.trainer import Trainer  # noqa: F401
from repro_torch.train.fault import StragglerMonitor, run_with_restarts  # noqa: F401
