"""The port's sharding tables against the JAX package's, exactly.

For every architecture the port's spec trees — parameters, decode cache
(16-bit and FP8), train state, batch and step inputs — must equal the
reference's leaf for leaf, after ``sanitize_spec``, under ``Rules()``,
``Rules(fsdp=True)``, ``Rules(sequence_parallel=True)`` and the serving
rules, on the single-pod and two-pod production meshes and on the
``{data: 1, model: 2}`` mesh the port executes.  The reference's
``sanitize_spec`` and ``decode_cache_specs`` read only ``mesh.shape``, so
a namespace with a shape stands in for its mesh.  No tolerance: specs are
compared for equality, shapes and dtypes too.
"""

import types

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import transformer as jt
from repro.optim import AdamW as JAdamW
from repro.runtime import sharding as js
from repro.serving import specs as jspecs

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.optim import AdamW as TAdamW
from repro_torch.runtime import sharding as ts
from repro_torch.serving import specs as tspecs

ARCHS = tconfigs.ARCH_IDS
MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pods2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x2": {"data": 1, "model": 2}}
RULES = ("plain", "fsdp", "sp", "serve")


def _rules(name, mod):
    r = {"plain": mod.Rules(), "fsdp": mod.Rules(fsdp=True),
         "sp": mod.Rules(sequence_parallel=True)}
    if name == "serve":
        return (jserve if mod is js else tserve).serve_rules()
    return r[name]


def _mesh(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _flat(tree, path=()):
    """``{path: leaf}`` of a tree of dicts / NamedTuples / tuples with
    spec leaves (either package's) or shape records."""
    if isinstance(tree, (JP, ts.PartitionSpec)):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    if hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(_flat(getattr(tree, f), path + (f,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    if hasattr(tree, "shape"):
        return {path: (tuple(tree.shape), np.dtype(tree.dtype).name
                       if not isinstance(tree.dtype, torch.dtype)
                       else str(tree.dtype).replace("torch.", ""))}
    return {path: tree}


def _sanitized(spec, shape, mesh, mod):
    return jax.tree.map(lambda s, a: mod.sanitize_spec(s, a.shape, mesh), spec, shape,
                        is_leaf=lambda x: isinstance(x, JP))


def _port_sanitized(spec, shape, mesh):
    if isinstance(spec, tuple):
        return ts.sanitize_spec(spec, tuple(shape.shape), mesh)
    return {k: _port_sanitized(spec[k], shape[k], mesh) for k in spec}


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, rules, mesh):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    m = _mesh(mesh)
    want = _sanitized(jt.param_specs(jcfg, _rules(rules, js)),
                      jt.abstract_params(jcfg), m, js)
    got = _port_sanitized(tt.param_specs(tcfg, _rules(rules, ts)),
                          tt.abstract_params(tcfg), m)
    assert _flat(got) == _flat(want)
    assert _flat(tt.abstract_params(tcfg)) == _flat(jt.abstract_params(jcfg))


def _cache_cases():
    for arch in ARCHS:
        kind = tconfigs.get(arch).block_kind
        for storage in (None, "float8_e4m3fn"):
            if storage and kind not in ("attn", "moe"):
                continue
            for mesh in MESHES:
                for rules in ("plain", "serve"):
                    yield arch, storage, mesh, rules


@pytest.mark.parametrize("arch,storage,mesh,rules", tuple(_cache_cases()))
def test_decode_cache_specs_equal_reference(arch, storage, mesh, rules):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    shp = tbase.SHAPES["decode_32k"]
    m = _mesh(mesh)
    jab, jsp = jspecs.decode_cache_specs(jcfg, _rules(rules, js), m, shp.global_batch,
                                         shp.seq_len, storage_dtype=storage)
    tab, tsp = tspecs.decode_cache_specs(tcfg, _rules(rules, ts), m, shp.global_batch,
                                         shp.seq_len, storage_dtype=storage)
    assert _flat(tsp) == _flat(jsp)
    assert _flat(tab) == _flat(jab)
    # the launcher's view routes through the same source
    assert _flat(tserve.cache_spec_tree(tcfg, _rules(rules, ts), m, shp.global_batch,
                                        shp.seq_len, storage_dtype=storage)) == _flat(jsp)


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_reference(arch, rules, mesh):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    m = _mesh(mesh)
    for use_scale in (False, True):
        want = jtrain.state_specs(jcfg, _rules(rules, js), m, JAdamW(),
                                  use_scale=use_scale)
        got = ttrain.state_specs(tcfg, _rules(rules, ts), m, TAdamW(),
                                 use_scale=use_scale)
        assert _flat(got) == _flat(want)


@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch, mesh):
    m = _mesh(mesh)
    assert (_flat(ttrain.batch_specs(tconfigs.get(arch), m))
            == _flat(jtrain.batch_specs(jconfigs.get(arch), m)))


@pytest.mark.parametrize("shape", tuple(tbase.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch, shape):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    got = tbase.input_specs(tcfg, tbase.SHAPES[shape])
    assert _flat(got) == _flat(jbase.input_specs(jcfg, jbase.SHAPES[shape]))
    assert all(t.device.type == "meta" for t in got.values())
    if tbase.SHAPES[shape].kind == "decode" and tcfg.block_kind in ("attn", "moe"):
        assert (_flat(tbase.cache_specs(tcfg, tbase.SHAPES[shape]))
                == _flat(jbase.cache_specs(jcfg, jbase.SHAPES[shape])))


# the reference's own cases (tests/test_sharding_roofline.py:25-60)
@pytest.mark.parametrize("case", ["basic", "no_axis_reuse", "fsdp", "overrides",
                                  "sanitize", "constrain_noop"])
def test_reference_rule_cases(case):
    if case == "basic":
        spec = ts.logical_spec(("batch", None, "ff"), ts.Rules())
        assert spec == ts.P(("pod", "data"), None, "model")
    elif case == "no_axis_reuse":
        assert ts.logical_spec(("heads", "ff"), ts.Rules()) == ts.P("model", None)
    elif case == "fsdp":
        assert (ts.logical_spec(("embed", "ff"), ts.Rules(fsdp=True))
                == ts.P(("pod", "data"), "model"))
        assert ts.logical_spec(("embed", "ff"), ts.Rules()) == ts.P(None, "model")
    elif case == "overrides":
        rules = ts.Rules(overrides=(("kv_seq", ("model",)),))
        assert ts.logical_spec(("kv_seq",), rules) == ts.P("model")
    elif case == "sanitize":
        m = types.SimpleNamespace(shape={"data": 2, "model": 2})
        out = ts.sanitize_spec(ts.P(("pod", "data"), "model"), (4, 5), m)
        assert out == ts.P("data")
        assert ts.sanitize_spec(ts.P("model"), (6,), m) == ts.P("model")
    else:
        x = torch.ones(4, 4)
        assert ts.constrain(x, "batch", None) is x
        with ts.use_rules(ts.Rules()):
            assert ts.constrain_both(x, "batch", None) is x
        assert ts.current_rules() is None


def test_production_meshes():
    one, two = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.size == 512
    assert tmesh.data_axes(two) == ("pod", "data") and tmesh.data_axes(one) == ("data",)
    host = tmesh.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1} and host.size == 1
    assert ts.DATA_AXES == js.DATA_AXES and ts.MODEL_AXIS == js.MODEL_AXIS
    assert ts.Rules().table() == js.Rules().table()
    # a description is no process group: a collective over it refuses
    with pytest.raises(RuntimeError, match="description"):
        one.group("model")
