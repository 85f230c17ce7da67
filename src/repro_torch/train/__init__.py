"""Training-side helpers the scheduler uses (straggler EWMA)."""
from repro_torch.train.fault_tolerance import StragglerTracker

__all__ = ["StragglerTracker"]
