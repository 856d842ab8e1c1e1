"""Runtime (counterpart of ``repro.runtime``): fault injection, the
fault-tolerant loop and goodput, data-parallel process groups and the
elastic worker.  Sharding over a mesh is not ported yet (ROADMAP.md,
Queue A)."""

from repro_torch.runtime.fault_tolerance import (FailureInjector, GoodputMeter,
                                                 InjectedFault, StragglerWatchdog,
                                                 TrainLoop, reshard)

__all__ = ["FailureInjector", "InjectedFault", "StragglerWatchdog",
           "GoodputMeter", "TrainLoop", "reshard"]
