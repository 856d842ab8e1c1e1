"""Runtime (counterpart of ``repro.runtime``): fault injection, the
fault-tolerant loop and goodput, data-parallel process groups, the
elastic worker, the logical-axis sharding rules (``sharding``) and the
collectives of a mesh of ranks (``collectives``)."""

from repro_torch.runtime.fault_tolerance import (FailureInjector, GoodputMeter,
                                                 InjectedFault, StragglerWatchdog,
                                                 TrainLoop, gather, reshard)

__all__ = ["FailureInjector", "InjectedFault", "StragglerWatchdog",
           "GoodputMeter", "TrainLoop", "reshard", "gather"]
