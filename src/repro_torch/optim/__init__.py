from repro_torch.optim.optimizers import (FusedAdam, FusedOptimizer,
                                          FusedSGD, Optimizer, adam,
                                          clip_by_global_norm, fused_adam,
                                          fused_sgd, global_norm_scale, sgd,
                                          trainable_mask)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        paper_halving_schedule)
