"""The port's partition specs (``repro_torch/launch/shardings.py``) against
the JAX package's ``repro/launch/shardings.py``: pure data, no mesh needed
(both rule sets read only the axis names and sizes of a stand-in).

* ``param_pspecs`` leaf for leaf for all ten configs × both production
  meshes × the three ``attn_weight_sharding`` variants;
* ``cache_pspecs`` for ``decode_32k`` and ``long_500k`` on both meshes;
* ``with_node_axis``, ``node_stack_specs``, ``commplan_in_specs``;
* the DTensor placements ``shardings_for`` gives (a ``("pod", "data")``
  entry is ``Shard(d)`` on both mesh dims, pod first);
* the argument bytes a rank holds for every (config × shape × mesh): the
  port's builders over a fake world of 256 / 512 ranks against the same sum
  over the JAX builders' specs and ``ShapeDtypeStruct``s.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.core.initialisation import InitConfig as JInitConfig  # noqa: E402
from repro.launch import shardings as JSH  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dtensor import fake_world  # noqa: E402
from repro_torch.launch import dryrun as PD  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402
from repro_torch.launch import shardings as PSH  # noqa: E402
from repro_torch.launch import steps as PS  # noqa: E402
from repro_torch.models import transformer as PTF  # noqa: E402


class FakeMesh:
    """Only .shape / .axis_names are read by either package's rules."""

    def __init__(self, multi_pod: bool):
        self.axis_names = ("pod", "data", "model") if multi_pod else ("data", "model")
        self.shape = dict(zip(self.axis_names, (2, 16, 16) if multi_pod else (16, 16)))


MESHES = {"pod16x16": FakeMesh(False), "pod2x16x16": FakeMesh(True)}
VARIANTS = ("auto", "replicate", "qkv_split")


@functools.cache
def _jax_params(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda k: JTF.init_params(k, cfg, JInitConfig(gain=1.0)), jax.random.PRNGKey(0))


def _jpath(path) -> str:
    return str(tuple(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None))) for k in path))


def _jspecs(tree, leaves_of=None) -> dict:
    """path → spec of a JAX spec tree, each padded with None to its leaf's rank."""
    specs = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    out = {_jpath(p): tuple(s) for p, s in specs}
    if leaves_of is not None:
        ranks = {_jpath(p): len(leaf.shape) for p, leaf in jax.tree_util.tree_flatten_with_path(leaves_of)[0]}
        out = {k: s + (None,) * (ranks[k] - len(s)) for k, s in out.items()}
    return out


def _pspecs(tree) -> dict:
    out = {}
    PSH.map_with_path(lambda p, s: out.__setitem__(str(p), tuple(s)), tree)
    return out


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_jax(arch, mesh, variant):
    jcfg = dataclasses.replace(jget_config(arch), attn_weight_sharding=variant)
    pcfg = dataclasses.replace(get_config(arch), attn_weight_sharding=variant)
    jparams = _jax_params(arch)
    want = _jspecs(JSH.param_pspecs(jparams, jcfg, MESHES[mesh]), jparams)
    got = _pspecs(PSH.param_pspecs(PS.abstract_params(get_config(arch)), pcfg, MESHES[mesh]))
    assert got == want


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_jax(arch, mesh, shape):
    sh = JS.SHAPES[shape]
    multi = mesh == "pod2x16x16"
    nax = "pod+data" if multi else "data"
    bdiv = sh.global_batch % (32 if multi else 16) == 0
    kw = dict(batch_axis=nax if bdiv else None, seq_axis=None if bdiv else nax)
    jcfg, pcfg = jget_config(arch), get_config(arch)
    jcache = jax.eval_shape(lambda: JTF.init_cache(jcfg, (sh.global_batch,), sh.seq_len))
    pcache = PTF.init_cache(pcfg, (sh.global_batch,), sh.seq_len, device="meta")
    want = _jspecs(JSH.cache_pspecs(jcache, jcfg, MESHES[mesh], **kw), jcache)
    assert _pspecs(PSH.cache_pspecs(pcache, pcfg, MESHES[mesh], **kw)) == want


@pytest.mark.parametrize("node_ax", [("data",), ("pod", "data")])
def test_node_axis_helpers_match_jax(node_ax):
    jparams = _jax_params("qwen2p5_3b")
    pparams = PS.abstract_params(get_config("qwen2p5_3b"))
    mesh = MESHES["pod2x16x16" if len(node_ax) > 1 else "pod16x16"]
    jspecs = JSH.param_pspecs(jparams, jget_config("qwen2p5_3b"), mesh)
    pspecs = PSH.param_pspecs(pparams, get_config("qwen2p5_3b"), mesh)
    assert _pspecs(PSH.with_node_axis(pspecs, node_ax)) == _jspecs(JSH.with_node_axis(jspecs, node_ax))
    assert _pspecs(PSH.node_stack_specs(pparams, node_ax)) == _jspecs(JSH.node_stack_specs(jparams, node_ax))
    for backend in ("dense", "sparse", "ppermute"):
        assert [tuple(s) for s in PSH.commplan_in_specs(backend, node_ax)] == [
            tuple(s) for s in JSH.commplan_in_specs(backend, node_ax)]


def test_placements_of_specs():
    mesh = MESHES["pod2x16x16"]
    assert PSH.placements_for(PSH.P(("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0), Shard(2))
    assert PSH.placements_for(PSH.P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert PSH.placements_for(PSH.P(), MESHES["pod16x16"]) == (Replicate(), Replicate())
    spec = PSH.P("model", None)
    assert spec == ("model", None) and repr(spec) == "P('model', None)"


# ------------------------------------------------------------ argument bytes
def _jax_arg_bytes(args, in_sh, mesh) -> int:
    specs = jax.tree_util.tree_leaves(in_sh, is_leaf=lambda x: isinstance(x, JP))
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(args), specs):
        shape = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            if entry is not None:
                shape[d] //= math.prod(mesh.shape[a] for a in (entry if isinstance(entry, tuple) else (entry,)))
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", list_archs())
def test_argument_bytes_per_rank_match_jax(arch, monkeypatch):
    """Every (shape × mesh): the bytes of a rank's shards of the port's
    example args (``dryrun._shard_bytes``, from the DeviceMesh's local
    shapes) against the JAX builder's specs and ``ShapeDtypeStruct``s (its
    ``NamedSharding`` replaced by the bare spec, so no 256-device mesh is
    needed)."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(JSH, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(JS, "_abstract_params", functools.cache(JS._abstract_params))
    for mesh_name, fake in MESHES.items():
        multi = mesh_name == "pod2x16x16"
        for shape in JS.SHAPES:
            _, jargs, jin, _ = JS.build(jget_config(arch), shape, fake, multi_pod=multi)
            want = _jax_arg_bytes(jargs, jin, fake)
            with fake_world(PM.N_CHIPS["multi" if multi else "single"]):
                mesh = PM.make_production_mesh(multi_pod=multi)
                _, args, in_sh, _ = PS.build(get_config(arch), shape, mesh, multi_pod=multi)
                assert PD._shard_bytes(args, in_sh) == want, (mesh_name, shape)
