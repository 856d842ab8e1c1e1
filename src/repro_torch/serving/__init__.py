"""Serving (counterpart of ``repro.serving``): the continuous-batching
scheduler, the FP8 KV cache's admission, integrity and byte accounting,
the Poisson load generator and the resilience layer (deadlines, admission
control, fault recovery, serve goodput), and ``decode_cache_specs`` (the
decode cache's abstract tree and sharding specs)."""

from repro_torch.serving.kv_cache import (cache_size_bytes, corrupt_slot_rows,
                                          decode_step_kv_bytes, insert_slot,
                                          is_fp8_cache, scale_health,
                                          slot_checksum)
from repro_torch.serving.loadgen import (LoadConfig, bench_rows, merge_bench_json,
                                         poisson_requests, run_load, slo_rows)
from repro_torch.serving.resilience import (Rejection, ServeGoodputMeter,
                                            ShedPolicy, SlotGuard)
from repro_torch.serving.scheduler import (Request, RequestResult, Scheduler,
                                           SchedulerConfig,
                                           instrumented_decode_events)
from repro_torch.serving.specs import decode_cache_specs

__all__ = [
    "cache_size_bytes", "corrupt_slot_rows", "decode_step_kv_bytes",
    "insert_slot", "is_fp8_cache", "scale_health", "slot_checksum",
    "LoadConfig", "bench_rows", "merge_bench_json", "poisson_requests",
    "run_load", "slo_rows",
    "Rejection", "ServeGoodputMeter", "ShedPolicy", "SlotGuard",
    "Request", "RequestResult", "Scheduler", "SchedulerConfig",
    "instrumented_decode_events", "decode_cache_specs",
]
