"""The port's partition rules (sharding/specs.py) and abstract inputs
(launch/shapes.py) against the JAX package's, on the CPU.

* Every parameter of every architecture at its full config, in the
  training and the inference layout: the port's spec equals JAX's
  ``param_specs(jax.eval_shape(init_params))`` through the bridge's own
  layout (``bridge.param_layouts``: the stacked layer entry dropped, the
  dims permuted as the copy permutes them), bitwise as tuples, and the
  port's shape equals JAX's permuted the same way; every JAX leaf is
  covered.  The port's models are built on the meta device without
  draws (``api.empty_params``).
* ``param_layouts`` agrees with the copy's walk (``bridge._walk``) on
  reduced models and on the U-Net.
* The reference tests' ``sanitize_spec``, Megatron, expert-parallel and
  inference-layout cases, and ``skip_reason`` for every pair.
* ``batch_spec_for``, ``kv_cache_spec`` and ``ssm_state_specs`` (JAX's
  with its leading stack entries dropped, the port's decode state being
  per layer), the client, plan, inject, handoff and cohort specs.
* Bytes per device of every pair's abstract inputs (params, AdamW
  state, batch, decode state) on the (16, 16) and (2, 16, 16) meshes,
  from a mesh of axis sizes alone, equal to the same sum over JAX's
  ``input_specs`` on an ``AbstractMesh``, exactly.
* ``make_client_mesh`` and ``collab_train.make_mesh``: JAX's rule (the
  largest rank count that divides the clients) over the process group,
  one ``gloo`` rank where none exists.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_arch as jget_arch
from repro.launch import shapes as JSH
from repro.models import api as japi
from repro.sharding import specs as JS
from repro_torch import bridge
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_arch, get_shape, \
    reduced
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as SH
from repro_torch.models import api
from repro_torch.sharding import specs as S

torch.set_num_threads(1)


class FakeMesh:
    """A mesh of axis sizes alone (the reference tests' ``FakeMesh``)."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"pod16x16": {"data": 16, "model": 16},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(functools.partial(japi.init_params,
                                            cfg=jget_arch(arch)),
                          jax.random.PRNGKey(0))


_EMPTY_PARAMS = api.empty_params      # as it is before any test patches it


@functools.lru_cache(maxsize=None)
def _meta_model(cfg):
    return _EMPTY_PARAMS(cfg, "meta")


def _flat_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(JS._path_names(p)): tuple(s) for p, s in leaves}


def _flat_shapes(tree):
    return {tuple(JS._path_names(p)): tuple(leaf.shape) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("inference", [False, True],
                         ids=["train", "inference"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax_through_the_bridge(arch, inference):
    shapes = _jax_params(arch)
    jspecs = _flat_specs(JS.param_specs(shapes, inference))
    jshapes = _flat_shapes(shapes)
    model = _meta_model(get_arch(arch))
    layouts = bridge.param_layouts(model)
    specs = S.param_specs(model, inference)
    covered = set()
    for name, p in model.named_parameters():
        path, layout = layouts[name]
        stacked = bridge.is_stacked(path)
        assert specs[name] == S.port_spec(jspecs[path], stacked, layout), \
            (name, specs[name], jspecs[path])
        assert tuple(p.shape) == S.port_spec(
            jshapes[path], stacked, layout), (name, p.shape, jshapes[path])
        covered.add(path)
    assert covered == set(jspecs)


def _walk_layouts(model, tree):
    """(JAX path, layout) of every parameter by the copy's own walk."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}

    def leaf(param, value, layout, name):
        parts = name.split(".")[1:]
        path = []
        for part in parts:
            head, _, idx = part.partition("[")
            path.append(head)
            if idx and head not in bridge.STACKS:
                path.append(f"[{idx}")
        out[names[id(param)]] = (tuple(path), layout)

    bridge._walk(model, bridge._unstack_layers(tree), "params", leaf)
    return out


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-base",
                                  "dbrx-132b", "internvl2-76b"])
def test_param_layouts_follow_the_copy(arch):
    cfg = reduced(jget_arch(arch))
    tree = jax.tree.map(np.asarray, japi.init_params(
        jax.random.PRNGKey(0), cfg))
    model = api.empty_params(reduced(get_arch(arch)), "cpu")
    assert bridge.param_layouts(model) == _walk_layouts(model, tree)


def test_param_layouts_of_the_unet():
    from repro.core import unet as junet
    from repro_torch.configs.ddpm_unet import SMALL
    from repro_torch.core.unet import UNet
    tree = jax.tree.map(np.asarray,
                        junet.init_unet(jax.random.PRNGKey(0), SMALL))
    model = UNet(SMALL)
    layouts = bridge.param_layouts(model)
    assert layouts == _walk_layouts(model, tree)
    assert {lay for _, lay in layouts.values()} == {"as_is", "hwio",
                                                    "dense"}


def test_megatron_expert_parallel_and_inference_layouts():
    """The reference tests' cases in the port's layout: nn.Linear stores
    (out, in), so JAX's ("data", "model") is ("model", "data") here."""
    kimi = _meta_model(get_arch("kimi-k2-1t-a32b"))
    train, infer = S.param_specs(kimi), S.param_specs(kimi, True)
    assert train["layers.0.moe.w_gate"] == ("model", "data", None)
    assert train["layers.0.moe.router"] == (None, None)
    assert infer["layers.0.attn.wq.weight"] == ("model", None)
    assert infer["layers.0.attn.wo.weight"] == (None, "model")
    assert infer["layers.0.moe.w_gate"] == ("model", None, "data")
    assert infer["layers.0.moe.w_down"] == ("model", "data", None)
    granite = S.param_specs(_meta_model(get_arch("granite-8b")))
    assert granite["layers.0.attn.wq.weight"] == ("model", "data")
    assert granite["layers.0.attn.wo.weight"] == ("data", "model")
    assert granite["layers.0.mlp.w_down.weight"] == ("data", "model")
    assert granite["embed.weight"] == ("model", None)
    mamba = S.param_specs(_meta_model(get_arch("mamba2-2.7b")), True)
    assert mamba["mamba.0.x_proj.weight"] == ("model", None)
    assert mamba["mamba.0.out_proj.weight"] == (None, "model")


def test_sanitize_drops_indivisible_and_absent_axes():
    mesh = FakeMesh({"data": 16, "model": 16})
    assert S.sanitize_spec(("model", None), (51865, 512), mesh) == \
        (None, None)
    assert S.sanitize_spec(("model", None), (65536, 512), mesh) == \
        ("model", None)
    pod = FakeMesh({"pod": 2, "data": 16})
    assert S.sanitize_spec((("pod", "data"), None), (48, 4), pod) == \
        (None, None)
    assert S.sanitize_spec((("pod", "data"), None), (64, 4), pod) == \
        (("pod", "data"), None)
    assert S.sanitize_spec(("clients", "data"), (4, 8),
                           FakeMesh({"clients": 4})) == ("clients", None)
    for spec, shape in ((("model", None), (51865, 512)),
                        ((("pod", "data"), None), (48, 4)),
                        ((("pod", "data"), None), (64, 4)),
                        (("data", "model"), (32, 8))):
        for m in (mesh, pod):
            assert S.sanitize_spec(spec, shape, m) == tuple(
                JS.sanitize_spec(P(*spec), shape, m))


def test_skip_reasons_equal_jax():
    for a in ARCH_IDS:
        for s in SHAPES:
            assert SH.skip_reason(get_arch(a), get_shape(s)) == \
                JSH.skip_reason(jget_arch(a), JSHAPES[s])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_input_and_state_specs_equal_jax(mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    for a in ARCH_IDS:
        cfg, jcfg = get_arch(a), jget_arch(a)
        for B in (1, 32, 128, 256):
            for trailing in (1, 2):
                assert S.batch_spec_for(mesh, B, trailing) == tuple(
                    JS.batch_spec_for(mesh, B, trailing))
            assert S.kv_cache_spec(mesh, cfg, B) == tuple(
                JS.kv_cache_spec(mesh, jcfg, B))[1:]
        if cfg.family not in ("ssm", "hybrid"):
            continue
        B = 128
        jstate = jax.eval_shape(functools.partial(
            japi.init_decode_state, jcfg, B, 64))
        jflat = {p[-1]: tuple(s) for p, s in _flat_specs(
            JS.ssm_state_specs(mesh, jcfg, B, jstate)).items()}
        state = api.init_decode_state(cfg, B, 64, device="meta")
        got = {}
        S._map_named(lambda n, leaf: got.setdefault(
            n, S.ssm_state_specs(mesh, cfg, B, {n: leaf})[n]), state)
        for name, spec in got.items():
            assert spec == jflat[name][len(jflat[name]) - len(spec):]
            assert all(e is None for e in
                       jflat[name][:len(jflat[name]) - len(spec)])


def test_client_plan_inject_handoff_and_cohort_specs_equal_jax():
    from repro.core import sample_plan as jplan
    from repro_torch.core import sample_plan as tplan
    stacked = {"w": np.zeros((4, 3, 3, 8, 16), np.float32),
               "b": np.zeros((4, 16), np.float32)}
    tstacked = {k: torch.from_numpy(v) for k, v in stacked.items()}
    jc = JS.client_stacked_specs(stacked)
    assert S.client_stacked_specs(tstacked) == {
        k: tuple(v) for k, v in jc.items()}
    jo = JS.client_opt_specs(stacked)
    to = S.client_opt_specs(tstacked)
    assert to["step"] == tuple(jo["step"])
    assert to["m"] == {k: tuple(v) for k, v in jo["m"].items()}
    for nd in (3, 4, 6):
        assert S.client_batch_spec(nd) == tuple(JS.client_batch_spec(nd))
        assert S.sample_stack_spec(nd) == tuple(JS.sample_stack_spec(nd))
        assert S.handoff_spec(nd) == tuple(JS.handoff_spec(nd))
    assert S.cohort_uid_spec() == tuple(JS.cohort_uid_spec())
    y = np.zeros((2, 8), np.float32)
    y[:, 1] = 1.0
    T = 10
    jreqs = [jplan.SampleRequest(c, t, y) for c, t in ((0, 2), (1, 5),
                                                      (0, 2))]
    treqs = [tplan.SampleRequest(c, t, y) for c, t in ((0, 2), (1, 5),
                                                      (0, 2))]
    jp = jplan.plan_requests(jreqs, T, n_clients=2, image_shape=(4, 4, 3),
                             lookup_fn=lambda gk: None)
    tp = tplan.plan_requests(treqs, T, n_clients=2, image_shape=(4, 4, 3),
                             lookup_fn=lambda gk: None, device="cpu")
    assert tuple(S.sample_plan_specs(tp.tables)) == tuple(
        tuple(s) for s in JS.sample_plan_specs(jp.tables))
    assert tuple(S.inject_specs(tp.inject)) == tuple(
        tuple(s) for s in JS.inject_specs(jp.inject))


def _jax_bytes(tree, mesh_shape) -> int:
    total = 0
    for leaf in jax.tree.leaves(tree):
        n = 1
        for e in leaf.sharding.spec:
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                n *= mesh_shape[a]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_bytes_per_device_equal_jax(mesh_name, monkeypatch):
    """Each pair's inputs, part by part, on a production mesh: the port's
    meta stand-ins over a mesh of axis sizes against JAX's
    ``ShapeDtypeStruct``s over an ``AbstractMesh``."""
    monkeypatch.setattr(SH.api, "empty_params",
                        lambda cfg, device: _meta_model(cfg))
    sizes = MESHES[mesh_name]
    mesh = FakeMesh(sizes)
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    for a in ARCH_IDS:
        cfg, jcfg = get_arch(a), jget_arch(a)
        for s, shape in SHAPES.items():
            if SH.skip_reason(cfg, shape) is not None:
                continue
            port = SH.input_specs(cfg, s, mesh)
            ref = JSH.input_specs(jcfg, s, amesh)
            if shape.kind == "decode":
                port, ref = port[:3], ref[:3]      # the position: host int
            assert len(port) == len(ref)
            for got, want in zip(port, ref):
                assert dryrun.device_bytes(got, mesh) == \
                    _jax_bytes(want, sizes), (a, s, type(got))


_CLIENT_MESH = r'''
import argparse, json, sys
sys.path.insert(0, {src!r})
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import collab_train
from repro_torch.sharding import specs
out = []
m = specs.make_client_mesh(6, device="cpu")      # no group: one rank
out.append([m.mesh_dim_names, m.size(), dist.get_backend()])
m = collab_train.make_mesh(argparse.Namespace(clients=5, device="cpu"))
out.append([m.mesh_dim_names, m.size()])
dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
for k in (6, 4, 5, 7, 16):
    out.append([k, specs.make_client_mesh(k, device="cpu").size()])
print("RESULT " + json.dumps(out))
'''


def test_client_meshes(tmp_path):
    """``make_client_mesh`` (and ``collab_train.make_mesh`` over it): the
    largest rank count of the group that divides the clients, as JAX's
    over its devices; one ``gloo`` rank where no group exists.  In a
    subprocess: the process groups must not meet other test files'."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _CLIENT_MESH.format(src=str(root / "src"))],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    out = json.loads(line[-1][len("RESULT "):])
    assert out[0] == [["clients"], 1, "gloo"]
    assert out[1] == [["clients"], 1]
    assert out[2:] == [[k, max(d for d in range(1, 9) if k % d == 0)]
                       for k in (6, 4, 5, 7, 16)] == \
        [[6, 6], [4, 4], [5, 5], [7, 7], [16, 8]]
