"""Training: the optimizer (`optimizer`), the microbatched train step
(`train_step`), the synthetic data pipeline (`data`), checkpoints
(`checkpoint`), and restart-on-fault with the straggler EWMA the scheduler
uses (`fault_tolerance`)."""
from repro_torch.train.fault_tolerance import StragglerTracker

__all__ = ["StragglerTracker"]
