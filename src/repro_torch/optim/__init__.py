from repro_torch.optim.optimizers import Optimizer, clip_by_global_norm, sgd, state_nbytes

__all__ = ["Optimizer", "clip_by_global_norm", "sgd", "state_nbytes"]
