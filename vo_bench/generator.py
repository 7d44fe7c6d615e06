"""The one traffic generator: reads a traffic mix (`vo_bench/traffic/<mix>.
json`) and makes its routes from the seed, rendered on the device at
set-up by the frozen renderer and kept as host uint8 arrays, as a PNG
decoder or a camera driver hands frames over.

A mix names a fixed pool of worlds (`world_seeds`), one route each,
driven in an order drawn from `--seed` by numpy's `SeedSequence`: every
seed does the same work in another order (a world drawn from each seed
changed the work far more than the host changed it, PERF.md), the same
seed gives the same frames and ground truth on every run, and any whole
number (also one beyond 32 bits) is a seed.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

from vo_bench.frozen import scene


class Route(NamedTuple):
    frames: List[np.ndarray]   # uint8 [H, W] each, views of one array
    poses_wc: np.ndarray       # [F, 4, 4] ground truth, world->camera
    world_seed: int


def camera(traffic: dict) -> scene.Camera:
    return scene.Camera.create(*traffic["world"]["camera"])


def render_route(world: dict, n_frames: int, seed: int, cam, device,
                 chunk: int = 32, times: dict = None) -> Route:
    """Build one world and render its `n_frames` frames on `device`, then
    copy them to the host in chunks of `chunk` frames; adds the seconds of
    each to `times` ("world_s", "render_s")."""
    times = {} if times is None else times
    t0 = time.perf_counter()
    seq = scene.TexturedSequence(
        n_frames=n_frames, height=world["height"], width=world["width"],
        step=world["step"], segments=tuple(map(tuple, world["segments"])),
        seed=seed, q_max=world["q_max"], tex_size=world["tex_size"],
        ss=world["ss"], light_period=world["light_period"],
        light_amp=world["light_amp"], cam=cam,
        mip_levels=world["mip_levels"], noise_sigma=world["noise_sigma"],
        device=device)
    t1 = time.perf_counter()
    out = np.empty((n_frames, world["height"], world["width"]), np.uint8)
    for c0 in range(0, n_frames, chunk):
        c1 = min(n_frames, c0 + chunk)
        out[c0:c1] = torch.stack([seq.frame(f) for f in range(c0, c1)]) \
            .cpu().numpy()
    times["world_s"] = times.get("world_s", 0.0) + t1 - t0
    times["render_s"] = times.get("render_s", 0.0) + time.perf_counter() - t1
    return Route(list(out), seq.poses[:n_frames], seed)


def route_seeds(traffic: dict, seed: int) -> List[int]:
    """The world seed of each route, in the order the routes are driven:
    the mix's pool (`world_seeds`), in an order drawn from the seed."""
    pool = traffic["world_seeds"]
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
    return [int(pool[i]) for i in rng.permutation(len(pool))]


def make(traffic: dict, seed: int, device,
         times: dict = None) -> List[Route]:
    """The mix's routes for this seed, `frames_per_route` frames each
    (`times`: see `render_route`)."""
    cam = camera(traffic)
    n = traffic["frames_per_route"]
    return [render_route(traffic["world"], n, s, cam, device, times=times)
            for s in route_seeds(traffic, seed)]
