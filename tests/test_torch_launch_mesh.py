"""The production mesh of the port (``repro_torch/launch/mesh.py``: ``N_CHIPS``,
``production_shape``, ``make_production_mesh``, ``node_axis``,
``n_fl_nodes``) against the JAX package's ``repro/launch/mesh.py``.

The JAX functions build a ``jax.make_mesh``, which needs as many devices
as the mesh has; here ``jax.make_mesh`` is replaced by a stand-in that
records the shape, so the JAX shape logic and errors run on one CPU
device.  The port's ``DeviceMesh`` is built over a fake process group of
256 / 512 ranks, made and destroyed inside each test.
"""
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.launch import mesh as JM  # noqa: E402
from repro_torch.dtensor import fake_world  # noqa: E402
from repro_torch.launch import mesh as PM  # noqa: E402

N_DEVICES = [None, 0, 1, 2, 3, 4, 8, 16, 24, 32, 40, 48, 64, 256, 512]  # 0, 24, 40 single-pod raise


@pytest.fixture
def jax_stand_in(monkeypatch):
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: SimpleNamespace(
        shape=dict(zip(axes, shape)), axis_names=tuple(axes), devices_shape=tuple(shape)))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("n_devices", N_DEVICES)
def test_shape_errors_and_fl_nodes_match_jax(jax_stand_in, n_devices, multi_pod):
    """The shape, or the error and its message, for every ``n_devices``;
    the node axis and ``n_fl_nodes``."""
    if n_devices in (0, 24, 40) and not multi_pod:
        with pytest.raises(ValueError):
            JM.make_production_mesh(multi_pod=multi_pod, n_devices=n_devices)
    try:
        want = JM.make_production_mesh(multi_pod=multi_pod, n_devices=n_devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            PM.production_shape(multi_pod=multi_pod, n_devices=n_devices)
        assert str(got.value) == str(e)
        with pytest.raises(ValueError):
            PM.n_fl_nodes(multi_pod=multi_pod, n_devices=n_devices)
        return
    shape, axes = PM.production_shape(multi_pod=multi_pod, n_devices=n_devices)
    assert axes == want.axis_names and shape == want.devices_shape
    assert PM.node_axis(multi_pod=multi_pod) == tuple(JM.node_axis(multi_pod=multi_pod))
    assert PM.n_fl_nodes(multi_pod=multi_pod, n_devices=n_devices) == JM.n_fl_nodes(
        multi_pod=multi_pod, n_devices=n_devices)


def test_chip_counts_and_default_nodes():
    assert PM.N_CHIPS == JM.N_CHIPS == {"single": 256, "multi": 512}
    assert PM.n_fl_nodes() == JM.n_fl_nodes() == 16
    assert PM.n_fl_nodes(multi_pod=True) == JM.n_fl_nodes(multi_pod=True) == 32


@pytest.mark.parametrize("multi_pod", [False, True])
def test_device_mesh_over_a_fake_world(multi_pod):
    """The production mesh over a fake world of 256 / 512 ranks: the JAX
    axis names and sizes, this process rank 0, torn down after."""
    shape, axes = PM.production_shape(multi_pod=multi_pod)
    with fake_world(PM.N_CHIPS["multi" if multi_pod else "single"]):
        mesh = PM.make_production_mesh(multi_pod=multi_pod)
        assert tuple(mesh.mesh_dim_names) == axes and tuple(mesh.shape) == shape
        assert mesh.device_type == "cpu" and list(mesh.get_coordinate()) == [0] * len(shape)
        assert dist.get_world_size(mesh.get_group("model")) == 16
        with pytest.raises(ValueError, match="has 256 ranks|has 512 ranks"):
            PM.make_production_mesh(multi_pod=not multi_pod)
    assert not dist.is_initialized()


def test_mesh_needs_a_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="none is initialised"):
        PM.make_production_mesh()


def test_import_touches_no_group_state():
    code = ("import torch.distributed as dist; import repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.launch.steps; print(dist.is_initialized())")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"
