"""Device meshes for the distributed window BA: one shard, one host's cards,
or several processes joined by `torch.distributed`.

Port of `ya_vo_tpu/parallel/mesh.py`. JAX's `jax.sharding.Mesh` becomes
`Mesh`: a numpy array of `torch.device`s and its axis names. A device may
repeat in a mesh: several shards on one device stand in for XLA's virtual
CPU devices, in the CPU tests and on a single card.

Across processes (`init_multihost`), a 1-D mesh lists this process's own
shards: the landmark-sharded solver (`parallel/dist_ba.py`) reads the
process group's rank and size from `torch.distributed`, and shard i of
process r is shard `r * mesh.size + i` of the whole. A 2-D mesh across
processes is the whole grid (`process_mesh`, or `map_mesh` with a process
group): JAX's global device order, every process's devices in turn
(process-major) reshaped to (kf, lm), with the process that holds each
shard in `Mesh.process`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_log = logging.getLogger("ya_vo_tpu_torch.parallel")


class Mesh:
    """`devices`, an array of torch devices (repeats allowed), with one
    name an axis. `process`, an int array of the same shape or None, is
    the rank of the process that holds each shard (a shard's device is a
    device of that process); None: every shard is this process's."""

    def __init__(self, devices, axis_names: Sequence[str], process=None):
        self.devices = np.frompyfunc(torch.device, 1, 1)(
            np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array with "
                             f"axes {self.axis_names}")
        self.process = None if process is None else np.asarray(process,
                                                               dtype=int)
        if (self.process is not None
                and self.process.shape != self.devices.shape):
            raise ValueError(f"process {self.process.shape} against devices "
                             f"{self.devices.shape}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


def _devices(device_type: str):
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if device_type == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")


def landmark_mesh(n_devices: Optional[int] = None, axis: str = "lm",
                  device_type: str = "cuda") -> Mesh:
    """1-D mesh over (up to) all visible CUDA devices for landmark sharding;
    `device_type="cpu"` gives one CPU shard."""
    devs = _devices(device_type)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def map_mesh(n_kf: int, n_lm: int, axes: Tuple[str, str] = ("kf", "lm"),
             device_type: str = "cuda") -> Mesh:
    """2-D mesh (keyframe blocks x landmark shards) for the 2-D distributed
    BA (parallel/dist_ba.make_dist_solver_2d): keyframe blocks ride the
    first axis, landmark shards the second, so the per-iteration Wpl
    all_gather stays within a kf column. With a process group of n
    processes, each gives n_kf * n_lm / n of its devices
    (`process_mesh`)."""
    devs = _devices(device_type)
    n_proc = process_count()
    need = n_kf * n_lm
    if need % n_proc or len(devs) < need // n_proc:
        raise ValueError(f"map_mesh({n_kf}x{n_lm}) needs {need} devices, "
                         f"have {len(devs)} in each of {n_proc} processes")
    if n_proc > 1:
        return process_mesh(devs[:need // n_proc], (n_kf, n_lm), axes)
    return Mesh(np.asarray(devs[:need], dtype=object).reshape(n_kf, n_lm),
                axes)


def process_mesh(local_devices, shape: Tuple[int, int],
                 axes: Tuple[str, str] = ("kf", "lm")) -> Mesh:
    """The whole 2-D grid across the process group, in JAX's global device
    order: process 0's `local_devices`, then process 1's, ..., reshaped to
    `shape`. Every process passes as many devices; the grid lists this
    process's own for every process's shards (a device of another process
    is not addressable here), and `Mesh.process` says whose each is."""
    n_proc = process_count()
    per = len(local_devices)
    if per * n_proc != shape[0] * shape[1]:
        raise ValueError(f"{n_proc} processes x {per} devices do not fill "
                         f"a {shape[0]}x{shape[1]} mesh")
    devs = np.asarray(list(local_devices) * n_proc, dtype=object)
    return Mesh(devs.reshape(shape), axes,
                process=np.repeat(np.arange(n_proc), per).reshape(shape))


def is_distributed_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if is_distributed_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed_initialized() else 0


def _backend(local_processes: int = 1) -> str:
    """NCCL for CUDA tensors where the build has it and each of the
    `local_processes` processes on this host has a card of its own, gloo
    otherwise: for the CPU, and for processes that share a card (NCCL
    refuses two ranks on one), whose CUDA collectives the solvers then
    stage through host memory (`parallel/dist_ba.py`). The choice is
    logged."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not cards or not dist.is_nccl_available():
        _log.info("process group backend gloo (no NCCL card)")
        return "gloo"
    if cards < local_processes:
        _log.warning("process group backend gloo: %d processes on this "
                     "host share %d card(s), and NCCL refuses two ranks "
                     "on one card", local_processes, cards)
        return "gloo"
    _log.info("process group backend cpu:gloo,cuda:nccl")
    return "cpu:gloo,cuda:nccl"


def _local_processes(coordinator: Optional[str],
                     num_processes: Optional[int]) -> int:
    """Processes of the group on this host: a manual cluster's all when
    its coordinator is on this host, else the launcher's count
    (LOCAL_WORLD_SIZE, SLURM_NTASKS_PER_NODE), else 1."""
    if coordinator is not None:
        host = coordinator.rsplit(":", 1)[0]
        local = host in ("localhost", "127.0.0.1", "::1", "[::1]")
        return int(num_processes or 1) if local else 1
    for key in ("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE"):
        n = os.environ.get(key, "").split("(")[0]
        if n.isdigit():
            return int(n)
    return 1


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize the default process group (idempotent), with
    `_backend`'s choice for the processes on this host
    (`_local_processes`).

    Three launch modes:
      * single host: call with no args — no-op.
      * managed launcher: call with no args AFTER the launcher exported
        the cluster env: torchrun's (WORLD_SIZE above 1, with its RANK
        and MASTER_ADDR/MASTER_PORT), or SLURM's (SLURM_NTASKS or
        SLURM_NPROCS above 1, SLURM_PROCID; MASTER_ADDR/MASTER_PORT
        exported by the job script). Only such env starts a group.
      * manual cluster: pass coordinator "host:port" plus num_processes
        and process_id explicitly (tests/test_torch_dist_ba.py does this
        across two OS processes).
    """
    if is_distributed_initialized():
        return
    if coordinator is not None:
        dist.init_process_group(_backend(_local_processes(coordinator,
                                                          num_processes)),
                                init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
        return
    env = os.environ

    def _int(k):
        try:
            return int(env.get(k, "0"))
        except ValueError:
            return 0

    # Auto-init ONLY on actual multi-process evidence: a 1-task shell
    # inside a SLURM allocation stays a single-host no-op.
    slurm = max(_int("SLURM_NTASKS"), _int("SLURM_NPROCS"))
    if _int("WORLD_SIZE") <= 1 and slurm <= 1:
        return
    backend = _backend(_local_processes(None, None))
    try:
        if _int("WORLD_SIZE") > 1:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method="env://",
                                    world_size=slurm,
                                    rank=_int("SLURM_PROCID"))
    except Exception as e:
        # fall back to single-process rather than crash a run whose
        # cluster env was merely inherited, not real
        _log.warning("torch.distributed.init_process_group() failed (%s); "
                     "continuing single-process", e)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
