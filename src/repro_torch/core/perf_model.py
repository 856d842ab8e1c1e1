"""The paper's analytic RedMulE machine model (counterpart of
``repro.core.perf_model``).

A cycle-accurate-at-tile-level model of the 22 nm PULP cluster with one
RedMulE instance (paper §II), calibrated against the published data
points.  Every constant below is the paper's silicon (its H x L x P array,
its clock and voltage corners, its cluster power and area): none
describes the H100, and nothing here is timed.  It reproduces:

  * 31.6 MAC/cycle peak = 98.8 % of the 32-FMA ideal        (Table I, Fig 4a)
  * 22x speedup over 8-core RISC-V software                  (§III-A)
  * 4.65x energy-efficiency gain over software               (§I, §IV)
  * 688 GFLOPS/W @ 0.65 V / 476 MHz, 462 GFLOPS/W @ 0.8 V    (Table I)
  * 42 GFLOPS @ 666 MHz                                      (Table I)
  * area 0.07 mm^2 = 14 % of the 0.5 mm^2 cluster; 256-FMA
    config ~ cluster area, 512-FMA ~ 2x cluster              (Fig 4b)
  * ports step 9 -> 11 when H: 4 -> 5                        (§III-A)
  * TinyMLPerf AutoEncoder: 2.6x speedup @ B=1 (bwd > fwd),
    ~16x HW throughput gain and 24.4x speedup @ B=16         (Fig 4c/4d)

Model structure (paper §II-B/C):
  The array is L rows x H columns of FMAs with P internal pipeline stages.
  A Z-tile of L rows x H*(P+1) columns is produced per pass; the reduction
  over N advances H elements per "lap" of H*(P+1) cycles around the row
  feedback path; Z is written once at the end of the reduction (store-once).
  Partial tiles occupy full laps with idle slots — this is exactly the
  small/skinny-matrix utilization collapse of Fig 3d and Fig 4c (K == batch).

The event consumers read the port's :class:`repro_torch.core.engine.GemmEvent`
stream (recorded on the CPU or on the card: the counts are the same), so
the paper's cycle model can price any workload the port runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.engine import is_pass_op
from repro_torch.roofline.analysis import bytes_by_direction, is_backward_event

__all__ = [
    "RedMulEModel",
    "GEMM",
    "DEFAULT_MODEL",
    "autoencoder_gemms",
    "autoencoder_report",
    "AE_DIMS",
    "gemms_from_events",
    "workload_cycles_from_events",
    "workload_cycles_by_direction",
    "workload_hbm_bytes_from_events",
    "dense_forward_gemms",
    "workload_flops",
]


@dataclasses.dataclass(frozen=True)
class GEMM:
    """Z = X @ W with X:(M,N), W:(N,K) — the paper's naming."""

    M: int
    N: int
    K: int

    @property
    def macs(self) -> int:
        return self.M * self.N * self.K


@dataclasses.dataclass(frozen=True)
class RedMulEModel:
    """Calibrated machine model of a PULP cluster + RedMulE instance."""

    # --- architecture parameters (paper: H=4, L=8, P=3 -> 32 FMAs) ---
    H: int = 4
    L: int = 8
    P: int = 3

    # --- calibrated schedule overheads (cycles) ---
    # register-file programming by the cores, per accelerator offload
    hw_startup: int = 100
    # X-buffer preload at the start of each M-row block (L 256-bit beats)
    hw_preload: int = 8

    # --- calibrated software baseline (8x RV32 cores, FP16 SW loops) ---
    sw_cores: int = 8
    # cycles per MAC per core; pinned by the published 22x peak speedup
    sw_cycles_per_mac: float = 5.52
    # per-GEMM fork/join + loop-setup overhead across the cluster
    sw_call_overhead: int = 10000

    # --- operating points (paper §III) ---
    freq_peak_eff_mhz: float = 476.0   # 0.65 V typical corner
    freq_peak_perf_mhz: float = 666.0  # 0.80 V
    vdd_peak_eff: float = 0.65
    vdd_peak_perf: float = 0.80
    cluster_power_peak_eff_mw: float = 43.5
    cluster_power_peak_perf_mw: float = 90.7
    # SW-mode cluster power, pinned by 4.65x efficiency at 22x speedup:
    # P_sw = P_hw * speedup_eff_ratio => 43.5 * 4.65 / 22
    sw_cluster_power_mw: float = 43.5 * 4.65 / 22.0

    # --- area model, least-squares fit to Fig 4b's three published points
    #     (32 FMA -> 0.07 mm^2, 256 -> ~0.5 = cluster, 512 -> ~1.0 = 2x) ---
    area_per_fma_mm2: float = 1.875e-3
    area_per_port_mm2: float = 1.25e-3
    area_fixed_mm2: float = 0.0
    cluster_area_mm2: float = 0.5

    # ------------------------------------------------------------------ #
    # Array geometry
    # ------------------------------------------------------------------ #
    @property
    def n_fmas(self) -> int:
        return self.H * self.L

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.n_fmas

    @property
    def lap_cycles(self) -> int:
        """One trip of the row feedback path: H FMAs x (P+1) slots."""
        return self.H * (self.P + 1)

    @property
    def z_tile_cols(self) -> int:
        """Z columns produced per pass = pipeline slots = H*(P+1)."""
        return self.H * (self.P + 1)

    def ports(self, H: int | None = None, P: int | None = None) -> int:
        """TCDM ports: H*(P+1) 16-bit elements / 32-bit port + 1 alignment
        port (paper: H=4,P=3 -> 9 ports; H=5 -> 11)."""
        H = self.H if H is None else H
        P = self.P if P is None else P
        return (H * (P + 1) * 16) // 32 + 1

    # ------------------------------------------------------------------ #
    # Cycle model
    # ------------------------------------------------------------------ #
    def hw_cycles(self, g: GEMM) -> int:
        """Cycles for RedMulE to compute Z = X @ W."""
        m_tiles = math.ceil(g.M / self.L)
        k_tiles = math.ceil(g.K / self.z_tile_cols)
        laps = math.ceil(g.N / self.H)
        # one Z tile = full N reduction + pipeline fill/drain
        tile = laps * self.lap_cycles + self.lap_cycles
        per_m = self.hw_preload + k_tiles * tile
        return self.hw_startup + m_tiles * per_m

    def sw_cycles(self, g: GEMM) -> float:
        """Cycles for the 8-core RISC-V software GEMM."""
        return g.macs * self.sw_cycles_per_mac / self.sw_cores + self.sw_call_overhead

    def hw_macs_per_cycle(self, g: GEMM) -> float:
        return g.macs / self.hw_cycles(g)

    def utilization(self, g: GEMM) -> float:
        return self.hw_macs_per_cycle(g) / self.peak_macs_per_cycle

    def speedup(self, g: GEMM) -> float:
        return self.sw_cycles(g) / self.hw_cycles(g)

    def workload_cycles(self, gemms: Sequence[GEMM]) -> Tuple[int, float]:
        hw = sum(self.hw_cycles(g) for g in gemms)
        sw = sum(self.sw_cycles(g) for g in gemms)
        return hw, sw

    # ------------------------------------------------------------------ #
    # Throughput / power / energy (paper §III-A, Table I)
    # ------------------------------------------------------------------ #
    def gmacs(self, g: GEMM, freq_mhz: float | None = None) -> float:
        f = (freq_mhz or self.freq_peak_perf_mhz) * 1e6
        return self.hw_macs_per_cycle(g) * f / 1e9

    def gflops(self, g: GEMM, freq_mhz: float | None = None) -> float:
        return 2.0 * self.gmacs(g, freq_mhz)

    def cluster_power_mw(self, g: GEMM, peak_perf: bool = False) -> float:
        """Cluster power at a utilization point: the RedMulE share (69 %)
        scales with array activity, the rest (TCDM/HCI 17.1 %, cores+misc
        13.9 %) is treated as always-on while the offload runs."""
        p = self.cluster_power_peak_perf_mw if peak_perf else self.cluster_power_peak_eff_mw
        u = self.utilization(g)
        return p * (0.69 * u + 0.31)

    def energy_per_mac_pj(self, g: GEMM, peak_perf: bool = False) -> float:
        f = (self.freq_peak_perf_mhz if peak_perf else self.freq_peak_eff_mhz) * 1e6
        p_w = self.cluster_power_mw(g, peak_perf) * 1e-3
        t_s = self.hw_cycles(g) / f
        return p_w * t_s / g.macs * 1e12

    def gflops_per_watt(self, g: GEMM, peak_perf: bool = False) -> float:
        f_mhz = self.freq_peak_perf_mhz if peak_perf else self.freq_peak_eff_mhz
        return self.gflops(g, f_mhz) / (self.cluster_power_mw(g, peak_perf) * 1e-3)

    def sw_gflops_per_watt(self, g: GEMM) -> float:
        f = self.freq_peak_eff_mhz * 1e6
        thr = g.macs / self.sw_cycles(g) * f * 2 / 1e9
        return thr / (self.sw_cluster_power_mw * 1e-3)

    def efficiency_gain_vs_sw(self, g: GEMM) -> float:
        return self.gflops_per_watt(g) / self.sw_gflops_per_watt(g)

    # ------------------------------------------------------------------ #
    # Area model (Fig 4b)
    # ------------------------------------------------------------------ #
    def area_mm2(self, H: int | None = None, L: int | None = None) -> float:
        H = self.H if H is None else H
        L = self.L if L is None else L
        return (
            self.area_per_fma_mm2 * H * L
            + self.area_per_port_mm2 * self.ports(H)
            + self.area_fixed_mm2
        )

    def area_fraction_of_cluster(self) -> float:
        return self.area_mm2() / self.cluster_area_mm2


DEFAULT_MODEL = RedMulEModel()


# ---------------------------------------------------------------------- #
# Engine instrumentation -> machine-model workloads
# ---------------------------------------------------------------------- #
# The engine (repro_torch.core.engine) emits a GemmEvent per dispatch;
# instead of re-deriving GEMM shapes by hand for every workload, the machine
# model consumes a recorded event stream directly.  Events are duck-typed
# (anything with .spec.{op,m,n,k,batch,groups}, .count and .recompute).
def gemms_from_events(events) -> List[Tuple[GEMM, int]]:
    """Convert engine ``GemmEvent``s into ``(GEMM, multiplicity)`` pairs.

    Each batched/grouped dispatch counts as ``batch * groups * count``
    independent (M, N, K) problems on the accelerator.  Backward events
    (``matmul_dx`` / ``matmul_dw`` from the engine's autograd backward) are
    ordinary pairs — the events of a loss and its gradients are the full
    train-step workload, fwd and bwd — and remat recompute events count
    too (the recompute executes).  Epilogue *pass* events
    (``*_dact`` / ``*_dbias``: the two-pass backward fallback's standalone
    ds multiply and bias-grad reduction) carry no MACs and are skipped —
    the cycle model prices GEMM passes on the array, not element-wise
    traffic.  Ragged grouped events keep the dense per-group shape here
    (an upper bound: the cycle model bills the padded tiles the array
    would sweep; the event's own ``flops``/``bytes`` already scale with
    ``valid_rows``)."""
    out: List[Tuple[GEMM, int]] = []
    for ev in events:
        if is_pass_op(ev.spec.op):
            continue
        s = ev.spec
        out.append((GEMM(M=s.m, N=s.n, K=s.k),
                    s.batch * s.groups * ev.count))
    return out


def workload_cycles_from_events(
    model: RedMulEModel, events
) -> Tuple[float, float]:
    """(hw_cycles, sw_cycles) of an instrumented workload on ``model``.

    Includes the backward GEMMs when the events cover a loss and its
    gradients — the engine's backward emits them like any other dispatch
    (use :func:`workload_cycles_by_direction` to split)."""
    pairs = gemms_from_events(events)
    hw = sum(model.hw_cycles(g) * c for g, c in pairs)
    sw = sum(model.sw_cycles(g) * c for g, c in pairs)
    return hw, sw


def workload_cycles_by_direction(
    model: RedMulEModel, events
) -> Dict[str, Tuple[float, float]]:
    """{"fwd": (hw, sw), "bwd": (hw, sw)} — the paper's Fig 4c split
    (bwd > fwd per layer: dX's skinny-K GEMM plus dW's fat-K GEMM),
    straight from an instrumented train step: a remat recompute counts as
    backward."""
    fwd = [ev for ev in events if not is_backward_event(ev)]
    bwd = [ev for ev in events if is_backward_event(ev)]
    return {
        "fwd": workload_cycles_from_events(model, fwd),
        "bwd": workload_cycles_from_events(model, bwd),
    }


def workload_flops(pairs: Sequence[Tuple[GEMM, int]]) -> int:
    """Total flops (2 * MACs) of a ``(GEMM, multiplicity)`` workload."""
    return sum(2 * g.macs * c for g, c in pairs)


def workload_hbm_bytes_from_events(events) -> Dict[str, int]:
    """{"total", "fwd", "bwd"} analytic HBM bytes of an instrumented
    workload, priced at each operand's **true storage width**.

    The per-event byte count comes from ``GemmSpec.bytes``, which bills
    the x/w operand slots at their per-operand storage dtypes
    (``GemmSpec.x_dtype`` / ``w_dtype``): under the mixed-precision FP8
    policies the operand streams pay one byte per element while the MAC
    count — and therefore every cycle/throughput figure this model
    produces — is unchanged.  That is the mixed-precision RedMulE's
    proposition in one line: **bytes drop, flops don't.**  Pass events
    (``*_dact``/``*_dbias``/``*_postep``) carry real bytes and are
    included, unlike in the cycle model.  The direction split defers to
    :func:`repro_torch.roofline.analysis.bytes_by_direction` — one source
    of truth for the fwd/bwd rule."""
    d = bytes_by_direction(events)
    return {"total": int(d["fwd"] + d["bwd"]),
            "fwd": int(d["fwd"]), "bwd": int(d["bwd"])}


def dense_forward_gemms(cfg, batch: int, seq: int) -> List[Tuple[GEMM, int]]:
    """Analytic GEMM enumeration of one dense-transformer forward pass.

    The oracle the engine's instrumentation is validated against (the
    reference's ``tests/test_engine.py``): every GEMM of a
    ``block_kind == "attn"`` GQA forward (no cache, ``seq <= q_chunk``, GLU MLP, with LM head) in
    the Engine's (batch, M, N, K) convention.
    """
    if cfg.block_kind != "attn" or cfg.mla is not None:
        raise ValueError("dense_forward_gemms covers dense GQA archs only")
    if seq > cfg.q_chunk:
        raise ValueError("seq > q_chunk: the q-chunk scan changes the shapes")
    if cfg.mlp != "glu":
        raise ValueError("dense_forward_gemms assumes the GLU MLP")
    B, S, d = batch, seq, cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, ff, V = cfg.n_layers, cfg.d_ff, cfg.vocab_size
    g = hq // hkv
    pairs: List[Tuple[GEMM, int]] = [
        (GEMM(M=S, N=d, K=(hq + 2 * hkv) * hd), B * L),   # fused qkv
        (GEMM(M=S, N=hd, K=S), B * hkv * g * L),          # scores  q @ k^T
        (GEMM(M=S, N=S, K=hd), B * hkv * g * L),          # context p @ v
        (GEMM(M=S, N=hq * hd, K=d), B * L),               # wo
        (GEMM(M=S, N=d, K=2 * ff), B * L),                # mlp w_in (gate|up)
        (GEMM(M=S, N=ff, K=d), B * L),                    # mlp w_out
        (GEMM(M=S, N=d, K=V), B),                         # lm head
    ]
    return pairs


# ---------------------------------------------------------------------- #
# TinyMLPerf AutoEncoder use case (paper §III-B, Fig 4c/4d)
# ---------------------------------------------------------------------- #
# MLPerf Tiny anomaly-detection deep AutoEncoder (ToyADMOS):
# 640 -> [128 x4] -> 8 -> [128 x4] -> 640.
AE_DIMS: Tuple[int, ...] = (640, 128, 128, 128, 128, 8, 128, 128, 128, 128, 640)


def autoencoder_gemms(batch: int) -> Dict[str, List[GEMM]]:
    """Forward + backward GEMMs of the AE at batch size B.

    Forward computes Z(out,B) = W(out,in) @ X(in,B): K == B — the skinny-K
    regime the paper calls out.  Backward per layer:
      dX(in,B)  = W^T(in,out) @ dZ(out,B)        (K == B again)
      dW(out,in) = dZ(out,B)  @ X^T(B,in)        (N == B, K == in: fat K)
    """
    fwd, bwd = [], []
    dims = AE_DIMS
    for i in range(len(dims) - 1):
        d_in, d_out = dims[i], dims[i + 1]
        fwd.append(GEMM(M=d_out, N=d_in, K=batch))
        bwd.append(GEMM(M=d_in, N=d_out, K=batch))   # dX
        bwd.append(GEMM(M=d_out, N=batch, K=d_in))   # dW
    return {"fwd": fwd, "bwd": bwd}


def autoencoder_report(model: RedMulEModel, batch: int) -> Dict[str, float]:
    gs = autoencoder_gemms(batch)
    hw_f, sw_f = model.workload_cycles(gs["fwd"])
    hw_b, sw_b = model.workload_cycles(gs["bwd"])
    macs = sum(g.macs for g in gs["fwd"] + gs["bwd"])
    params = sum(AE_DIMS[i] * AE_DIMS[i + 1] + AE_DIMS[i + 1] for i in range(len(AE_DIMS) - 1))
    acts = batch * sum(AE_DIMS)
    return {
        "batch": batch,
        "hw_cycles": hw_f + hw_b,
        "sw_cycles": sw_f + sw_b,
        "speedup": (sw_f + sw_b) / (hw_f + hw_b),
        "speedup_fwd": sw_f / hw_f,
        "speedup_bwd": sw_b / hw_b,
        "hw_macs_per_cycle": macs / (hw_f + hw_b),
        # fp16 activation + gradient working set (the B-dependent part the
        # paper's "184 kB @ B=16" tracks; params are B-independent and
        # reported separately)
        "footprint_kb": 2 * acts * 2 / 1024.0,
        "params_kb": params * 2 / 1024.0,
    }
