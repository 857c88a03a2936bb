"""Multi-process bootstrap (counterpart of `mcpt_tpu/parallel/distributed.py`).

`init_distributed()` starts `torch.distributed` from explicit arguments or
from the standard environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`,
`RANK`), so that the same train step runs in one process or in several:
when a process group exists, `diff.make_train_step` all-reduces its
gradients and loss as a mean over the processes. Render-level fault
tolerance is the tile checkpoint of `render.render_radiance`.
"""

import datetime
import os

import torch
import torch.distributed as dist


def init_distributed(init_method=None, world_size=None, rank=None, backend=None,
                     timeout_s: float = 300.0) -> bool:
    """Initialise the default process group; True if distributed mode is
    active. Returns False (and does nothing) when neither the arguments
    nor the environment (`MASTER_ADDR`) ask for one. `backend` defaults to
    nccl where there is a card, else gloo."""
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is None and world_size is None:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kw = {"init_method": init_method, "timeout": datetime.timedelta(seconds=timeout_s)}
    if world_size is not None:
        kw.update(world_size=int(world_size), rank=int(rank))
    dist.init_process_group(backend, **kw)
    return True


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
