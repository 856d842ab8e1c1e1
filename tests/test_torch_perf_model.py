"""The port's accounting layer against the JAX package, on the CPU.

* ``repro_torch.core.perf_model`` — the paper's analytic RedMulE model —
  reproduces every figure ``tests/test_perf_model.py`` pins, and equals
  the reference's model on the same GEMMs: the cycle model, the dense
  forward enumeration for every registered arch (reduced) and the
  AutoEncoder report;
* ``repro_torch.roofline.analysis``: ``model_flops`` for every registered
  arch (reduced) times ``SHAPES``, and the flop / byte / cycle splits by
  direction of the AutoEncoder step, a two-layer remat'd qwen3 step and
  the reduced xLSTM step, each against the reference's on its own events;
* the ``--instrument`` summary of ``launch/train.py``: a remat recompute is
  backward work, as the reference counts it.

Everything here is a count: the comparisons are exact.  The LM step's
attention is the one documented difference in the event streams (the
reference's layer scan routes it through q-chunked batched matmuls, the
port runs flash and recomputes through the composition), so there the
reference's stream takes its attention from ``engine.attention`` at the
same shapes with the flash tiles pinned, as ``tests/test_torch_lm_train.py``
holds the events; for the xLSTM the reference's second, recompute-tagged
bill of the sweep backward's composition is subtracted, as
``tests/test_torch_train.py`` does.
"""

import collections
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core import engine as je
from repro.core import perf_model as jpm
from repro.core import precision as jprec
from repro.data import SyntheticAE as JSyntheticAE
from repro.launch import train as jtrain
from repro.models import autoencoder as jae
from repro.models import transformer as jt
from repro.roofline import analysis as ja

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.core import engine as te
from repro_torch.core import perf_model as tpm
from repro_torch.core import precision as tprec
from repro_torch.core import tiling
from repro_torch.data import SyntheticAE
from repro_torch.launch import train as ttrain
from repro_torch.models import autoencoder as tae
from repro_torch.models import transformer as tt
from repro_torch.optim import tree_leaves
from repro_torch.roofline import analysis as ta

M = tpm.DEFAULT_MODEL


# --------------------------------------------------------------------- #
# The paper's figures through the port's copy (tests/test_perf_model.py)
# --------------------------------------------------------------------- #
def test_peak_utilization_98_8pct():
    g = tpm.GEMM(304, 304, 304)
    assert abs(M.hw_macs_per_cycle(g) - 31.6) < 0.15
    assert M.utilization(g) > 0.985
    assert M.utilization(tpm.GEMM(1024, 1024, 1024)) > M.utilization(g)


def test_speedup_efficiency_and_table1():
    g = tpm.GEMM(1024, 1024, 1024)
    assert abs(M.speedup(g) - 22.0) < 0.5
    assert abs(M.efficiency_gain_vs_sw(g) - 4.65) < 0.25
    assert abs(M.gflops(g, M.freq_peak_perf_mhz) - 42.0) < 1.0
    assert abs(M.gflops_per_watt(g) - 688.0) < 25.0
    assert abs(M.gflops_per_watt(g, peak_perf=True) - 462.0) < 15.0


def test_area_ports_and_fig4b():
    assert abs(M.area_mm2() - 0.07) < 0.005
    assert abs(M.area_fraction_of_cluster() - 0.14) < 0.01
    assert abs(M.area_mm2(8, 32) - M.cluster_area_mm2) < 0.02
    assert abs(M.area_mm2(16, 32) - 2 * M.cluster_area_mm2) < 0.03
    assert M.ports(4) == 9 and M.ports(5) == 11


def test_skinny_k_collapse_and_monotone_energy():
    assert M.utilization(tpm.GEMM(128, 640, 1)) < 0.10
    assert M.utilization(tpm.GEMM(128, 640, 128)) > 0.8
    e = [M.energy_per_mac_pj(tpm.GEMM(s, s, s)) for s in (16, 32, 64, 128, 256, 512)]
    assert all(a > b for a, b in zip(e, e[1:])) and e[-1] < 3.2
    base = tpm.GEMM(64, 64, 64)
    for g in (tpm.GEMM(256, 64, 64), tpm.GEMM(64, 256, 64), tpm.GEMM(64, 64, 256)):
        assert M.utilization(g) >= M.utilization(base)


def test_autoencoder_fig4cd():
    r1, r16 = tpm.autoencoder_report(M, 1), tpm.autoencoder_report(M, 16)
    assert 2.3 < r1["speedup"] < 3.1                  # paper: 2.6x
    assert r1["speedup_bwd"] > r1["speedup_fwd"]
    assert 18.0 < r16["speedup"] < 27.0               # paper: 24.4x
    assert 10.0 < r16["hw_macs_per_cycle"] / r1["hw_macs_per_cycle"] < 16.5
    macs = lambda b: sum(g.macs for gs in tpm.autoencoder_gemms(b).values() for g in gs)
    assert (macs(16) / r16["sw_cycles"]) / (macs(1) / r1["sw_cycles"]) < 1.6


# --------------------------------------------------------------------- #
# The port's model equals the reference's
# --------------------------------------------------------------------- #
_GEMMS = [(1, 1, 1), (8, 4, 12), (128, 640, 1), (304, 304, 304), (640, 16, 128),
          (17, 33, 65), (1024, 1024, 1024), (3, 5000, 7)]


@pytest.mark.parametrize("mnk", _GEMMS)
def test_cycle_model_equals_reference(mnk):
    tg, jg = tpm.GEMM(*mnk), jpm.GEMM(*mnk)
    jm = jpm.DEFAULT_MODEL
    assert dataclasses.asdict(M) == dataclasses.asdict(jm)
    for name in ("hw_cycles", "sw_cycles", "utilization", "speedup",
                 "energy_per_mac_pj", "gflops_per_watt", "efficiency_gain_vs_sw"):
        assert getattr(M, name)(tg) == getattr(jm, name)(jg), name
    assert M.workload_cycles([tg, tg]) == jm.workload_cycles([jg, jg])


@pytest.mark.parametrize("batch", [1, 2, 16, 64, 4096])
def test_autoencoder_report_equals_reference(batch):
    assert tpm.autoencoder_report(M, batch) == jpm.autoencoder_report(
        jpm.DEFAULT_MODEL, batch)
    assert tpm.AE_DIMS == jpm.AE_DIMS


def _pairs(ps):
    return [((g.M, g.N, g.K), c) for g, c in ps]


def _same_outcome(f_port, f_ref):
    """Both raise ValueError, or both return the same value."""
    try:
        want = f_ref()
    except ValueError:
        with pytest.raises(ValueError):
            f_port()
        return None
    got = f_port()
    assert got == want
    return got


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_dense_forward_gemms_and_model_flops_equal_reference(arch):
    tcfg, jcfg = tconfigs.get_reduced(arch), jconfigs.get_reduced(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert set(tbase.SHAPES) == set(jbase.SHAPES)
    for name, shape in tbase.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jbase.SHAPES[name])
        assert ta.model_flops(tcfg, shape) == ja.model_flops(jcfg, jbase.SHAPES[name])
    for batch, seq in ((1, 8), (2, 32), (3, tcfg.q_chunk), (1, tcfg.q_chunk + 1)):
        _same_outcome(lambda: _pairs(tpm.dense_forward_gemms(tcfg, batch, seq)),
                      lambda: _pairs(jpm.dense_forward_gemms(jcfg, batch, seq)))


def test_roofline_report_terms():
    kw = dict(arch="qwen3-1.7b", shape="train_4k", mesh="single", n_devices=1,
              flops_per_device=2e12, bytes_per_device=1e9,
              coll_bytes_per_device=0.0, collectives={}, memory_analysis={},
              model_flops=1.5e12)
    t = ta.RooflineReport(compute_s=2e12 / ta.PEAK_FLOPS, memory_s=1e9 / ta.HBM_BW,
                          collective_s=0.0, **kw)
    assert t.dominant == "compute" and t.bound_s == 2e12 / 989e12
    assert t.useful_flops_ratio == 0.75
    assert t.roofline_fraction == pytest.approx(0.75)
    assert t.to_json()["dominant"] == "compute"
    assert (ta.PEAK_FLOPS, ta.FP8_PEAK_FLOPS, ta.FP32_PEAK_FLOPS, ta.HBM_BW) == (
        989e12, 1979e12, 67e12, 3.35e12)


# --------------------------------------------------------------------- #
# Splits by direction, each package on its own events
# --------------------------------------------------------------------- #
def _accounting(pm, an, events):
    return {"cycles": pm.workload_cycles_by_direction(pm.DEFAULT_MODEL, events),
            "cycles_total": pm.workload_cycles_from_events(pm.DEFAULT_MODEL, events),
            "flops": an.flops_by_direction(events),
            "bytes": an.bytes_by_direction(events),
            "hbm": pm.workload_hbm_bytes_from_events(events),
            "total": an.flops_from_events(events),
            "gemm_flops": pm.workload_flops(pm.gemms_from_events(events))}


def _port(events):
    return _accounting(tpm, ta, events)


def _ref(events):
    return _accounting(jpm, ja, events)


def test_split_rule_is_the_references():
    """The port's consumers give the reference's numbers on the
    reference's own events (duck-typed), a recompute counted backward."""
    ev = collections.namedtuple("ev", "spec count recompute flops bytes")
    spec = collections.namedtuple("spec", "op m n k batch groups")
    events = [ev(spec(op, 8, 16, 24, 2, 1), 3, rc, 10 * i, 7 * i)
              for i, (op, rc) in enumerate([("matmul", False), ("matmul", True),
                                            ("matmul_dx", False), ("linear_dact", False),
                                            ("linear_postep", False), ("matmul_dw", False)])]
    assert _port(events) == _ref(events)
    assert _port(events)["flops"] == {"fwd": 3.0 * (0 + 40), "bwd": 3.0 * (10 + 20 + 30 + 50)}


@pytest.fixture(scope="module")
def ae_events():
    jp = jae.init_ae(jax.random.PRNGKey(0))
    x = jnp.asarray(JSyntheticAE(batch=16).sample(0))
    with je.instrument() as jev:
        jax.eval_shape(lambda p: jax.value_and_grad(lambda q: jae.ae_loss(
            q, x, policy=jprec.PAPER_FP16, backend="interpret")[0])(p), jp)
    params = convert.ae_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with te.instrument() as tev:
        loss, _ = tae.ae_loss(params, torch.from_numpy(SyntheticAE(batch=16).sample(0)),
                              policy=tprec.PAPER_FP16)
        torch.autograd.grad(loss, tree_leaves(params))
    return tev, jev


def test_ae_step_accounting_equals_reference(ae_events):
    tev, jev = ae_events
    got = _port(tev)
    assert got == _ref(jev)
    # the paper's Fig 4c direction: the backward costs more cycles
    assert got["cycles"]["bwd"][0] > got["cycles"]["fwd"][0]


def test_cycle_model_reads_the_events_tile_free(ae_events):
    """The cycle model reads shapes, not the launch geometry: a cached
    tile stamped on every event moves no count."""
    tev, _ = ae_events
    tiled = [dataclasses.replace(e, spec=dataclasses.replace(
        e.spec, tile=tiling.TileConfig(bm=16, bn=32, bk=128))) for e in tev]
    assert _port(tiled) == _port(tev)


def _flat(e) -> bool:
    """Every GEMM of the LM step but the attention's (batched tags)."""
    return not e.spec.tag.startswith("b")


def _qwen3_events(policy="tpu_bf16", B=2, S=32, layers=2):
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3-1.7b"), policy_name=policy,
                               n_layers=layers)
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen3-1.7b"), policy_name=policy,
                               n_layers=layers)
    rng = np.random.default_rng(0)
    b = {"inputs": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)}
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    with je.use_backend("interpret"), je.instrument() as jev:
        jax.eval_shape(jax.value_and_grad(lambda p, x: jt.loss_fn(p, jcfg, x),
                                          has_aux=True),
                       jparams, {k: jnp.asarray(v) for k, v in b.items()})
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu", dtype=torch.float32)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    with te.instrument() as tev:
        loss, _ = tt.loss_fn(tparams, tcfg, {k: torch.from_numpy(v).long()
                                             for k, v in b.items()})
        torch.autograd.grad(loss, leaves)
    # the reference's attention as engine.attention bills it under a remat
    # region, at the step's shapes with the flash tiles pinned
    hq, hkv, hd = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim

    def layers_fn(q, k, v):
        def body(c, _):
            return c + je.attention(q * c, k, v, t_valid=S, bq=tiling.FLASH_BQ,
                                    bkv=tiling.FLASH_BKV, policy=policy,
                                    backend="interpret").astype(jnp.float32).sum(), 0
        with je.repeat(layers):
            c, _ = jax.lax.scan(jax.checkpoint(body), jnp.float32(1), None,
                                length=layers)
        return c

    z = lambda h: jnp.zeros((B, h, S, hd), jcfg.compute_dtype)
    with je.instrument() as jattn:
        jax.eval_shape(jax.value_and_grad(layers_fn, argnums=(0, 1, 2)),
                       z(hq), z(hkv), z(hkv))
    return tev, [e for e in jev if _flat(e)] + list(jattn), jev


@pytest.fixture(scope="module")
def qwen3_events():
    return _qwen3_events()


def test_remat_qwen3_step_accounting_equals_reference(qwen3_events):
    tev, jev, _ = qwen3_events
    assert any(e.recompute for e in tev)
    assert _port(tev) == _ref(jev)
    # the projections and the head alone, on the reference's own stream
    assert _port([e for e in tev if _flat(e)]) == _ref([e for e in jev if _flat(e)])


def _summary(mod, events) -> dict:
    """The ``[engine] fwd_* / train/inference`` lines one package's
    ``--instrument`` summary prints for ``events``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod._print_instrument_summary(events)
    return {line.split()[1].split("=")[0]: line for line in buf.getvalue().splitlines()
            if line.startswith("[engine] fwd_")}


def _old_split(events) -> str:
    """The summary's ratio as the port printed it before it counted a
    remat recompute as backward (the op name alone)."""
    fwd = sum(e.total_flops for e in events if not te.is_backward_op(e.spec.op))
    return f"{sum(e.total_flops for e in events) / fwd:.2f}x"


def test_instrument_cli_split_equals_reference(capsys, monkeypatch):
    """``launch.train --arch qwen3-1.7b --reduced --batch 2 --seq 32
    --instrument`` in both packages.  The reference prints fwd 0.015 /
    bwd 0.040 GFLOP, 3.71x; the port printed 0.026 / 0.029, 2.14x, when
    it split by op name alone.  Its summary is now the reference's, line
    for line, on the stream the reference bills for the same step (its
    flat GEMMs and its attention as ``engine.attention`` bills it), and
    the GFLOP figures equal the reference CLI's own at print precision."""
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "2", "--seq", "32",
            "--instrument"]
    seen = {}

    class _Stop(Exception):
        pass

    def grab(events):
        seen["events"] = list(events)
        raise _Stop

    monkeypatch.setattr(jtrain, "_print_instrument_summary", grab)
    with pytest.raises(_Stop):
        jtrain.main(argv + ["--steps", "1"])
    monkeypatch.undo()
    ref_cli = _summary(jtrain, seen["events"])
    assert ref_cli["fwd_gflops"].endswith(
        "fwd_gflops=0.015 bwd_gflops=0.040 train/inference=3.71x")

    capsys.readouterr()
    ttrain.main(argv + ["--device", "cpu", "--steps", "0"])
    port_cli = {line.split()[1].split("=")[0]: line
                for line in capsys.readouterr().out.splitlines()
                if line.startswith("[engine] fwd_")}
    tev, jev, _ = _qwen3_events()
    assert port_cli == _summary(ttrain, tev)
    assert port_cli == _summary(jtrain, jev)
    gflops = lambda line: line.split()[1:3]
    assert gflops(port_cli["fwd_gflops"]) == gflops(ref_cli["fwd_gflops"])
    # the parent's rule on the same events: 2.14x against the reference's 3.71x
    assert _old_split(tev) == "2.14x"


def test_xlstm_step_accounting_equals_reference():
    """The reduced xLSTM step (fp32, remat "full", the sweep kernel), less
    the reference's second, recompute-tagged bill of the sweep backward's
    composition forward (one per mLSTM layer)."""
    jcfg = dataclasses.replace(jconfigs.get_reduced("xlstm-1.3b"), policy_name="fp32")
    tcfg = dataclasses.replace(tconfigs.get_reduced("xlstm-1.3b"), policy_name="fp32")
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    b = {"inputs": rng.integers(0, 512, (2, 24)).astype(np.int32),
         "labels": rng.integers(-1, 512, (2, 24)).astype(np.int32)}
    with je.use_backend("interpret"), je.instrument() as jev:
        jax.eval_shape(jax.value_and_grad(lambda p, x: jt.loss_fn(p, jcfg, x),
                                          has_aux=True),
                       jparams, {k: jnp.asarray(v) for k, v in b.items()})
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu", dtype=torch.float32)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    with te.instrument() as tev:
        loss, _ = tt.loss_fn(tparams, tcfg, {k: torch.from_numpy(v).long()
                                             for k, v in b.items()})
        torch.autograd.grad(loss, leaves)
    H = jcfg.n_heads
    hd = jcfg.ssm.mlstm_proj_factor * jcfg.d_model // H
    z = jnp.zeros((2, H, 24, hd), jnp.float32)
    with je.instrument() as comp:
        je._linear_attention_reference(z, z, z, z[..., 0], chunk=jcfg.ssm.chunk,
                                       state=None, backend="interpret")
    n_mlstm = jcfg.n_layers // jcfg.ssm.slstm_period * (jcfg.ssm.slstm_period - 1)
    extra = [dataclasses.replace(e, recompute=True) for e in comp] * n_mlstm
    got, less = _port(tev), _ref(extra)
    assert less["flops"]["fwd"] == 0 and less["flops"]["bwd"] > 0
    _assert_close(got, _minus(_ref(jev), less))


def _minus(a, b):
    """``a - b`` leaf by leaf: every accounting is a sum over events."""
    if isinstance(a, dict):
        return {k: _minus(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_minus(x, y) for x, y in zip(a, b))
    return a - b


def _assert_close(got, want):
    """Equal leaf by leaf; the software model's cycles (5.52 per MAC, a
    float) to 1e-12 relative, since a difference of float sums is not
    exact — every other leaf sums integers and is held exactly."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            _assert_close(got[k], want[k])
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        hw, sw = got
        assert hw == want[0]
        assert sw == pytest.approx(want[1], rel=1e-12)
    else:
        assert got == want
