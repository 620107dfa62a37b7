"""The device mesh of the multi-device routes, and the process group
that spans hosts.

Counterpart of the JAX package's ``distributed.py``.  The reference
lays a ``jax.sharding.Mesh`` over its devices and drives it
single-controller: one process runs every device of a host.  The port
keeps that layout:

  * :class:`ShardMesh` is the ``"shard"`` axis: an ordered tuple of
    ``torch.device``s driven by this process.  A device may repeat, so
    ``ShardMesh(["cpu"] * 8)`` stands where the reference's tests put 8
    virtual CPU devices, and ``ShardMesh(["cuda:0"] * 4)`` is 4 logical
    shards on one card;
  * the optional outer ``"keys"`` axis spans processes, one per host,
    joined by a ``torch.distributed`` process group
    (:func:`init_process_group`).

The layout doctrine is the reference's: the sharded-frontier search
(``search_opseq_sharded``) exchanges rows every level, so its shard
axis stays inside one process; the batch of independent keys needs no
communication but the final gather, so the keys axis may cross hosts.
:func:`multihost_mesh` builds that two-axis mesh, and
:func:`keys_sharding` the sharding ``search_batch(sharding=)`` takes.

Usage on each host (every process runs the same program with the whole
key list)::

    from jepsen_tpu_torch import distributed as dist
    dist.init_process_group(coordinator="host0:29500", num_processes=2,
                            process_id=rank, device="cuda:0")
    mesh = dist.multihost_mesh(devices=["cuda:0"])
    results = search_batch(seqs, model,
                           sharding=dist.keys_sharding(mesh))

Every process checks its block of the keys and returns the whole list.
Nothing here reads the environment: the cluster comes in as arguments.
"""

from __future__ import annotations

import datetime

import torch

__all__ = ["ShardMesh", "KeysSharding", "init_process_group",
           "shutdown_process_group", "is_initialized", "process_info",
           "multihost_mesh", "keys_sharding", "as_sharding"]

_INITIALIZED = False


class ShardMesh:
    """An ordered tuple of devices on the axis ``axis`` (default
    ``"shard"``), driven by this process, and optionally an outer axis
    ``keys_axis`` over the processes of the ``torch.distributed`` group
    (:func:`init_process_group`; size 1 without one).  All devices are
    of one type; a device may repeat.  :attr:`key` is the mesh's part of
    every kernel-cache key."""

    def __init__(self, devices, *, axis: str = "shard",
                 keys_axis: str | None = None):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"mixed device types in one mesh: {devs}")
        if keys_axis is not None and keys_axis == axis:
            raise ValueError(f"the two axes share the name {axis!r}")
        self.devices = devs
        self.axis = axis
        self.keys_axis = keys_axis

    @property
    def size(self) -> int:
        """Devices on the shard axis."""
        return len(self.devices)

    @property
    def n_processes(self) -> int:
        """Processes on the keys axis (1 without one)."""
        if self.keys_axis is None:
            return 1
        return _world()[1]

    @property
    def process_index(self) -> int:
        if self.keys_axis is None:
            return 0
        return _world()[0]

    @property
    def shape(self) -> dict:
        """Axis name to size, the outer axis first (``Mesh.shape``)."""
        out = {}
        if self.keys_axis is not None:
            out[self.keys_axis] = self.n_processes
        out[self.axis] = self.size
        return out

    @property
    def key(self) -> tuple:
        return (self.axis, self.keys_axis, self.n_processes,
                tuple(str(d) for d in self.devices))

    def __repr__(self) -> str:
        return (f"ShardMesh({[str(d) for d in self.devices]}, "
                f"shape={self.shape})")


class KeysSharding:
    """The leading (key) axis of a batch laid over ``axis`` of ``mesh``:
    the port's ``NamedSharding(mesh, PartitionSpec(axis))``.  Over the
    keys axis the processes split the keys, and each process splits its
    block over its shard devices; over the shard axis this process
    checks every key over its devices."""

    def __init__(self, mesh: ShardMesh, axis: str | None = None):
        axis = mesh.axis if axis is None else axis
        if axis not in mesh.shape:
            raise ValueError(f"axis {axis!r} is not in the mesh's "
                             f"{tuple(mesh.shape)}")
        self.mesh = mesh
        self.axis = axis

    @property
    def n_processes(self) -> int:
        """Processes that split the keys."""
        return self.mesh.n_processes if self.axis == self.mesh.keys_axis \
            else 1

    @property
    def spans_processes(self) -> bool:
        """Whether the keys go over a process group: the keys axis of a
        mesh whose processes joined one (even a group of one)."""
        import torch.distributed as tdist

        return (self.axis == self.mesh.keys_axis and tdist.is_available()
                and tdist.is_initialized())

    @property
    def num_devices(self) -> int:
        return self.mesh.size * self.n_processes

    def local(self) -> "KeysSharding":
        """This process's part: its shard devices, no keys axis."""
        return KeysSharding(ShardMesh(self.mesh.devices,
                                      axis=self.mesh.axis))

    def __repr__(self) -> str:
        return f"KeysSharding({self.mesh!r}, axis={self.axis!r})"


def as_sharding(sharding) -> KeysSharding | None:
    """``search_batch``'s ``sharding`` as a :class:`KeysSharding`: None
    stays None, a bare :class:`ShardMesh` shards over its shard axis."""
    if sharding is None or isinstance(sharding, KeysSharding):
        return sharding
    if isinstance(sharding, ShardMesh):
        return KeysSharding(sharding)
    raise TypeError(f"sharding must be a ShardMesh or a KeysSharding, "
                    f"got {type(sharding).__name__}")


def _world() -> tuple[int, int]:
    """(rank, size) in the process group, (0, 1) without one."""
    import torch.distributed as tdist

    if not (tdist.is_available() and tdist.is_initialized()):
        return 0, 1
    return tdist.get_rank(), tdist.get_world_size()


def init_process_group(*, coordinator: str | None = None,
                       num_processes: int | None = None,
                       process_id: int | None = None, device=None,
                       timeout: float = 120.0) -> bool:
    """Join the process group of a multi-host run: ``coordinator`` is
    ``host:port`` of process 0 (``tcp://`` optional), ``num_processes``
    the world size and ``process_id`` this process's rank.  ``device``
    picks the backend: ``nccl`` for a CUDA device (set as this process's
    current device first, as NCCL's object collectives need), ``gloo``
    for the CPU.  A collective that waits longer than ``timeout``
    seconds raises instead of hanging.

    Returns False with no argument given (standalone: everything
    downstream runs single-host), True once the group is up.  Some but
    not all of the three raise: a silent standalone run would leave the
    peers waiting for this process."""
    global _INITIALIZED
    import torch.distributed as tdist

    if _INITIALIZED and tdist.is_initialized():
        return True
    pieces = {"coordinator": bool(coordinator),
              "num_processes": bool(num_processes and num_processes > 0),
              "process_id": process_id is not None and process_id >= 0}
    if not any(pieces.values()):
        return False
    if not all(pieces.values()):
        missing = sorted(k for k, ok in pieces.items() if not ok)
        raise ValueError(f"partial cluster configuration: missing or "
                         f"invalid {missing}")
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but "
                "torch.cuda.is_available() is False; pass device='cpu'")
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    addr = coordinator if coordinator.startswith("tcp://") \
        else f"tcp://{coordinator}"
    tdist.init_process_group(
        backend, init_method=addr, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout))
    _INITIALIZED = True
    return True


def shutdown_process_group() -> None:
    """Leave the process group :func:`init_process_group` joined."""
    global _INITIALIZED
    import torch.distributed as tdist

    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()
    _INITIALIZED = False


def is_initialized() -> bool:
    return _INITIALIZED


def process_info(devices=None) -> dict:
    """This process's coordinates in the job (rank 0 of 1 standalone).
    ``devices`` are its shard devices; by default every local card."""
    rank, size = _world()
    local = len(devices) if devices is not None else (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    return {"process_index": rank, "process_count": size,
            "local_devices": local, "global_devices": local * size}


def multihost_mesh(devices=None, *, ici_axis: str = "shard",
                   dcn_axis: str = "keys") -> ShardMesh:
    """A two-axis mesh over the job: the outer axis ``dcn_axis`` spans
    the processes (give it the keys of a batch) and the
    inner axis ``ici_axis`` is this process's ``devices`` (give it a
    sharded frontier, whose rows cross it every level).  ``devices``
    defaults to every local card.  Standalone the outer axis has size 1
    and the mesh is a plain single-host mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "multihost_mesh() defaults to the local cards and "
                "torch.cuda.is_available() is False; pass devices=")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return ShardMesh(devices, axis=ici_axis, keys_axis=dcn_axis)


def keys_sharding(mesh: ShardMesh, axis: str = "keys") -> KeysSharding:
    """The sharding that lays a batch's keys over ``axis`` of ``mesh``
    (default the outer ``"keys"`` axis), for
    ``search_batch(sharding=)``."""
    return KeysSharding(mesh, axis)
