"""Device meshes for the distributed window BA: one shard, one host's cards,
or several processes joined by `torch.distributed`.

Port of `ya_vo_tpu/parallel/mesh.py`. JAX's `jax.sharding.Mesh` becomes
`Mesh`: a numpy array of `torch.device`s and its axis names. A device may
repeat in a mesh: several shards on one device stand in for XLA's virtual
CPU devices, in the CPU tests and on a single card.

Across processes (`init_multihost`), a mesh lists this process's own
shards. The solvers (`parallel/dist_ba.py`) read the process group's rank
and size from `torch.distributed`, and shard i of process r is shard
`r * mesh.size + i` of the whole.
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
    name an axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.frompyfunc(torch.device, 1, 1)(
            np.asarray(devices, dtype=object))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device array with "
                             f"axes {self.axis_names}")

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
    all_gather stays within a kf column."""
    devs = _devices(device_type)
    need = n_kf * n_lm
    if len(devs) < need:
        raise ValueError(f"map_mesh({n_kf}x{n_lm}) needs {need} devices, "
                         f"have {len(devs)}")
    return Mesh(np.asarray(devs[:need], dtype=object).reshape(n_kf, n_lm),
                axes)


def is_distributed_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if is_distributed_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_distributed_initialized() else 0


def _backend() -> str:
    """NCCL for CUDA tensors where the build has it, gloo for the CPU."""
    if torch.cuda.is_available() and dist.is_nccl_available():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Initialize the default process group (idempotent).

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
        dist.init_process_group(_backend(), init_method=f"tcp://{coordinator}",
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
    try:
        if _int("WORLD_SIZE") > 1:
            dist.init_process_group(_backend())
        else:
            dist.init_process_group(_backend(), init_method="env://",
                                    world_size=slurm,
                                    rank=_int("SLURM_PROCID"))
    except Exception as e:
        # fall back to single-process rather than crash a run whose
        # cluster env was merely inherited, not real
        _log.warning("torch.distributed.init_process_group() failed (%s); "
                     "continuing single-process", e)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
