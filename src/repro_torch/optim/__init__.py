from repro_torch.optim.optimizers import (OptState, adamw_init, adamw_update,
                                          make_optimizer)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup
