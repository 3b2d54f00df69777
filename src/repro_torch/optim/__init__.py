from repro_torch.optim.adamw import (  # noqa: F401
    AdamWState, adamw_init, adamw_update, global_norm, lr_schedule,
)
from repro_torch.optim.compression import (  # noqa: F401
    ef_compress_grads, ef_init,
)
