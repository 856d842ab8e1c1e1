"""Runtime: the serving modes of the fault injector (counterpart of
``repro.runtime``; the training loop, checkpoints, elastic resume and
sharding are not ported yet, see ROADMAP.md, Queue A 6)."""

from repro_torch.runtime.fault_tolerance import FailureInjector, InjectedFault

__all__ = ["FailureInjector", "InjectedFault"]
