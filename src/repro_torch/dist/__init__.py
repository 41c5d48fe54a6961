"""Distribution layer of the port: mesh-role description, layout builders,
their eager execution, and the compressed all-reduce (the twin of
``repro/dist``).  The PyTorch APIs it codes against are imported through
:mod:`repro_torch.dist.compat`, which names any the installed torch
lacks."""
from repro_torch.dist import compression  # noqa: F401
from repro_torch.dist.sharding import (  # noqa: F401
    Parallel,
    batch_shardings,
    cache_shardings,
    opt_state_shardings,
    param_shardings,
    replicated,
    serving_cache_shardings,
)
