from repro_torch.optim.optimizers import (Optimizer, adam, adamw,
                                          clip_by_norm, get_optimizer, lamb,
                                          make_schedule, sgd,
                                          tree_global_norm)

__all__ = ["Optimizer", "adam", "adamw", "clip_by_norm", "get_optimizer",
           "lamb", "make_schedule", "sgd", "tree_global_norm"]
