"""The packed-BNN serving mesh (DESIGN.md §10): an ordered tuple of
devices on one ``"data"`` axis, driven by one process.

The JAX package serves on a ``jax.sharding.Mesh`` from one controller:
packed weights replicated, the batch sharded, a collective-free forward
(``bnn_serve_fn(mesh=)``). The port's counterpart is a list of devices in
one process: one replica of the packed weights on each, a batch split into
one contiguous shard a replica, every shard launched before any result is
collected (``distributed.sharding``, ``serve.executor``). No process group
and no collective is needed.

The same mesh is the 1-D ``"data"`` mesh of data-parallel training
(``train.bnn_trainer.make_dp_train_step``, ``train.resilience``): one
batch shard a replica, the gradients reduced in mesh order on the first
replica's device.

On the CPU a mesh of ``n`` entries ``cpu:0 .. cpu:n-1`` is the counterpart
of the JAX package's forced host devices: every entry is the CPU, and the
shards run one after another through the plain-torch twins.

LM training over the model axis runs on a :class:`DeviceMesh`: a device
grid with named axes, the JAX ``Mesh``'s ``.shape`` / ``.axis_names`` /
``.devices``, laid out as the JAX launcher lays out its devices
(:func:`make_device_mesh`, from ``distributed.fault_tolerance.
make_elastic_mesh``). One process drives every entry, and entries may
repeat one card (ranks sharing it run one after another) or be CPU
entries, as a ``ServingMesh``'s may; a ``ServingMesh`` is its 1-D
``("data",)`` case.

Either mesh may instead run one process a device (SPMD, as the JAX
package's sharded steps run): ``distributed.process_group.bind`` gives
each process the mesh with ``position``, the flat index it holds, and the
training steps then compute that position's part alone, their collectives
going through ``torch.distributed``.

The LM dry run's production meshes (``SINGLE_POD``, ``MULTI_POD``,
:func:`make_production_mesh`) are abstract: an :class:`AbstractMesh` holds
the axis names and sizes the rule table (``distributed.sharding``) and the
roofline read, and no device.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bnn import resolve_device


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A 1-D ``("data",)`` mesh, for serving and for data-parallel
    training: ``devices`` in mesh order.

    Any non-empty sequence of CUDA devices, or of CPU devices, is
    accepted, repeats included (as ``jax.sharding.Mesh`` takes any device
    array): several replicas may share one card, each with its own
    stream, graph pool and graphs. A mix of CUDA and CPU devices raises.

    ``position`` is the replica this process runs where the mesh runs one
    process a device (``distributed.process_group.bind``), ``None`` where
    one process drives every replica.
    """

    devices: tuple
    position: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "devices", _devices_of_one_kind(self.devices))

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)


def make_serving_mesh(n_devices: Optional[int] = None, *,
                      device=None) -> ServingMesh:
    """The serving mesh over the first ``n_devices`` devices of a kind.

    CUDA unless ``device`` names the CPU (``core.bnn.resolve_device``,
    which raises when CUDA is asked for and absent): the first
    ``n_devices`` visible cards, all of them by default; ``ValueError``
    for ``n_devices < 1`` and ``RuntimeError`` when fewer cards exist,
    as the JAX package's ``make_serving_mesh``. On the CPU, ``n_devices``
    entries ``cpu:0 ..`` for any ``n_devices`` (default 1). No device
    repeats."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
    else:
        have = None
        n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"serving mesh needs >= 1 device, got {n}")
    if have is not None and have < n:
        raise RuntimeError(f"need {n} CUDA devices for the serving mesh, "
                           f"have {have}")
    return ServingMesh(tuple(torch.device(dev.type, i) for i in range(n)))


def _devices_of_one_kind(devices) -> tuple:
    """``devices`` as ``torch.device``s, CUDA ones with their index made
    explicit; ``ValueError`` for none, or for a mix of kinds."""
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs >= 1 device")
    kinds = {d.type for d in devs}
    if len(kinds) > 1 or not kinds <= {"cuda", "cpu"}:
        raise ValueError("a mesh holds CUDA devices or CPU devices, not "
                         f"{sorted(map(str, devs))}")
    if "cuda" in kinds:
        devs = tuple(d if d.index is not None else torch.device(
            "cuda", torch.cuda.current_device()) for d in devs)
    return devs


class DeviceMesh:
    """A device grid with named axes, the JAX ``jax.sharding.Mesh`` as one
    process drives it: ``devices`` a numpy object array of
    ``torch.device`` (mesh order is its C order), ``axis_names`` one name
    a grid axis, ``.shape`` axis name -> size in axis order. The same
    devices as a :class:`ServingMesh` accepts: CUDA entries (repeats
    share a card) or CPU entries, not a mix. ``position`` is the flat
    mesh index this process holds where the mesh runs one process a
    device (``distributed.process_group.bind``), ``None`` where one
    process drives every entry."""

    def __init__(self, devices, axis_names, position: Optional[int] = None):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid for the axes "
                             f"{axis_names}")
        flat = np.empty(grid.size, dtype=object)
        flat[:] = _devices_of_one_kind(grid.reshape(-1))
        self.devices = flat.reshape(grid.shape)
        self.axis_names = axis_names
        self.position = position

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> tuple:
        """Every device in mesh order."""
        return tuple(self.devices.reshape(-1))


def make_device_mesh(devices, *, model_parallel: int = 16) -> DeviceMesh:
    """The JAX launcher's LM training mesh over ``devices``:
    ``distributed.fault_tolerance.make_elastic_mesh`` (``plan_mesh_for``),
    ``(data, model)`` with ``model = model_parallel`` once there are that
    many devices, else the 1-D ``("data",)`` mesh of them all. The JAX
    launcher asks ``model_parallel=min(len(devices), 16)``."""
    from repro_torch.distributed.fault_tolerance import make_elastic_mesh
    grid, axes = make_elastic_mesh(list(devices), model_parallel=model_parallel)
    return DeviceMesh(grid, axes)


# Both meshes carry the full (pod, data, model) axis-name set so one
# sharding-rule table serves both; single-pod just has pod=1.
SINGLE_POD = (1, 16, 16)              # 256 chips
MULTI_POD = (2, 16, 16)               # 512 chips
PRODUCTION_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of ``axis_sizes`` devices on ``axis_names``, with no device
    behind it: what the sharding rules and the dry run read of a
    ``jax.sharding.Mesh`` (``.shape``, ``.axis_names``, ``.size``)."""

    axis_sizes: tuple
    axis_names: tuple = PRODUCTION_AXES

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} axis sizes for the axes "
                             f"{self.axis_names}")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh axes need >= 1 device, got {self.axis_sizes}")

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, in axis order (``jax.sharding.Mesh.shape``)."""
        return collections.OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The JAX dry run's production mesh, ``SINGLE_POD`` (256 devices) or
    ``MULTI_POD`` (512) over ``("pod", "data", "model")``, as an
    :class:`AbstractMesh`: it touches no device and opens no process
    group. The port plans such a fleet from one process, which cannot run
    it: the dry run (``launch.dryrun``) shards every cell by the rule table
    against this mesh and reckons its cost per device; training runs on a
    ``ServingMesh`` of the devices one process drives."""
    return AbstractMesh(MULTI_POD if multi_pod else SINGLE_POD)


__all__ = ["AbstractMesh", "DeviceMesh", "MULTI_POD", "SINGLE_POD",
           "ServingMesh", "make_device_mesh", "make_production_mesh",
           "make_serving_mesh"]
