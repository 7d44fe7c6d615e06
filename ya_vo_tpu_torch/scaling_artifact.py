"""Record the distributed window BA's scaling sweep on CUDA devices as a
committed artifact (docs/SCALING_TORCH.json).

    python -m ya_vo_tpu_torch.scaling_artifact [--out PATH] [--device cpu]

Port of `tools/scaling_artifact.py` (whose docs/SCALING.json holds the JAX
package's record). The production window problem (L=16384, W=8):
  * the single-process sweep through `parallel.scaling_bench.measure`:
    1-D landmark meshes of 1, 2, 4 and 8 shards and the 2-D meshes 2x4,
    4x2 and 2x2, ms a GN iteration, speedup, efficiency and each shard's
    collective payload;
  * two processes joined by `torch.distributed` (subprocesses, as the
    tool's are), two shards each: the landmark-sharded solver over the 4
    shards ("2 processes x 2 shards", the tool's row) and the 2-D solver at
    2x2 in JAX's process-major layout (a process a kf block), each with ms
    a GN iteration, the cost decrease and the payload.

With two cards or more each process takes its own (process p on cuda:p)
and the group runs NCCL for CUDA tensors. With one card both processes
share it; NCCL refuses two ranks on one card, so `mesh.init_multihost`
picks gloo (and logs it) and the solvers stage each collective through
host memory. Every row says which backend it ran with (null: one process,
no group), whether its shards had distinct devices (`distinct_devices`),
and the card's name and power limit. The tool's `projected_ici_ms` is
dropped: it divides the payload by a TPU v5e link rate, and no NVLink rate
has been measured.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

from ya_vo_tpu_torch import require_device
from ya_vo_tpu_torch.parallel import dist_ba, scaling_bench
from ya_vo_tpu_torch.parallel import mesh as mesh_lib

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(_REPO, "docs", "SCALING_TORCH.json")
L, W = 16384, 8
ITERS, REPEATS = 4, 3
PER_PROCESS = 2          # shards a process in the two-process rows
WORKER_TIMEOUT = 900


def worker(pid: int, coordinator: str, device: str, L: int = L, W: int = W,
           iters: int = ITERS, repeats: int = REPEATS) -> None:
    """One of the two processes: join the group, solve the problem with
    the 1-D and the 2-D solver over both processes' shards, and (process
    0) print the rows as a `ROWS <json>` line."""
    device = torch.device(device)
    mesh_lib.init_multihost(coordinator, num_processes=2, process_id=pid)
    try:
        cam, prob = scaling_bench.build_problem(L, W, device=device)
        local = [device] * PER_PROCESS
        n = 2 * PER_PROCESS
        solvers = (
            ("2 processes x 2 shards", (1, n), dist_ba.make_dist_solver(
                mesh_lib.Mesh(local, ("lm",)), cam, iters=iters)),
            ("2x2 over 2 processes x 2 shards", (2, 2),
             dist_ba.make_dist_solver_2d(
                 mesh_lib.process_mesh(local, (2, 2)), cam, iters=iters)))
        rows = []
        for name, (n_kf, n_lm), solve in solvers:
            out = solve(prob)
            scaling_bench.sync_devices([device])    # warm
            t0 = time.perf_counter()
            for _ in range(repeats):
                out = solve(prob)
            scaling_bench.sync_devices([device])
            dt = (time.perf_counter() - t0) / repeats / iters
            c0, c1 = float(out[2]), float(out[3])
            if not c1 < c0:
                raise RuntimeError(f"{name}: cost {c0} -> {c1}")
            coll = dist_ba.collective_bytes_per_iter(W, L, n_kf, n_lm)
            rows.append(dict(
                mesh=name, devices=n, processes=2,
                ms_per_gn_iter=round(dt * 1e3, 3),
                cost_decrease=round(c0 / max(c1, 1e-9), 2),
                collective_mb_per_iter=round(coll["ring_bytes"] / 2**20, 3),
                backend=str(torch.distributed.get_backend())))
        if pid == 0:
            print("ROWS " + json.dumps(rows), flush=True)
    finally:
        torch.distributed.destroy_process_group()


def process_devices(device_type: str) -> list:
    """Each process's device: a card a process where there are two, else
    one shared device."""
    if device_type == "cuda" and torch.cuda.device_count() >= 2:
        return ["cuda:0", "cuda:1"]
    dev = "cuda:0" if device_type == "cuda" else "cpu"
    return [dev, dev]


def run_two_processes(device_type: str, **size) -> list:
    """The two-process rows, each with `distinct_devices`."""
    devices = process_devices(device_type)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "SLURM_NTASKS", "SLURM_NPROCS")}
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from ya_vo_tpu_torch.scaling_artifact import worker; "
         f"worker(int(sys.argv[1]), {coord!r}, {devices[pid]!r}, "
         f"**{size!r})", str(pid)],
        cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {pid} failed:\n{out}")
    shards = [d for d in devices for _ in range(PER_PROCESS)]
    distinct = len(set(shards)) == len(shards)
    for line in outs[0].splitlines():
        if line.startswith("ROWS "):
            return [dict(r, distinct_devices=distinct)
                    for r in json.loads(line[5:])]
    raise RuntimeError(f"no ROWS line:\n{outs[0]}")


def record(device: str = "cuda", L: int = L, W: int = W,
           iters: int = ITERS, repeats: int = REPEATS) -> dict:
    """The artifact's record (every shard of the single-process sweep on
    the first device when only one is visible)."""
    device_type = require_device(device).type
    if device_type == "cuda":
        from ya_vo_tpu_torch.selfcheck import card_line
        card = card_line()
        devs = list(mesh_lib.landmark_mesh().devices)
    else:
        card, devs = "cpu", [torch.device("cpu")]
    if len(devs) < 8:
        devs = (devs * 8)[:8]
    print(f"[scaling] single-process sweep on {sorted(set(map(str, devs)))}"
          f"...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    single = scaling_bench.measure(
        L, W, iters=iters, device_counts=[1, 2, 4, 8],
        mesh_shapes=[(2, 4), (4, 2), (2, 2)], repeats=repeats, devices=devs)
    print(f"[scaling] done in {time.perf_counter() - t0:.0f} s; "
          f"two processes...", file=sys.stderr, flush=True)
    multi = run_two_processes(device_type, L=L, W=W, iters=iters,
                              repeats=repeats)
    for row in single + multi:
        row.setdefault("backend", None)
        row["card"] = card
    return {
        "generated_by": "ya_vo_tpu_torch/scaling_artifact.py",
        "date": time.strftime("%Y-%m-%d"),
        "problem": {"landmarks": L, "window_keyframes": W,
                    "gn_iters_timed": iters},
        "note": ("shards that share a device (distinct_devices false) "
                 "measure the cost of sharding, not scaling; with one "
                 "card the two processes share it under gloo, each "
                 "collective staged through host memory; no link rate is "
                 "projected (no NVLink rate measured)"),
        "single_host": single,
        "multi_host_2proc": multi[0],
        "multi_host_2proc_2d": multi[1],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    rec = record(a.device)
    with open(a.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(f"[scaling] wrote {a.out}", file=sys.stderr)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
