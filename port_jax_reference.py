#!/usr/bin/env python3
"""The JAX package's frontend on `chip_smoke.py`'s workload, on the CPU: the
like-for-like reference for the port's main-path numbers.

    JAX_PLATFORMS=cpu python3 port_jax_reference.py [--runs RUN,...]

Runs `ya_vo_tpu.tracking.frontend.Frontend.run(pipelined=True)` over the
40-frame 376x1241 stamps world (`chip_smoke.SEQ`), RUN being one of
(all three by default):
  ba_off   - VOConfig() with only window BA off (chip_smoke.py phase 4);
  ba_on    - VOConfig() unmodified (phase 5);
  blackout - VOConfig() unmodified, two black frames after frame 20
             (phase 6).
On the CPU the JAX frontend would track with `lk.track`; the TPU and the
port run `lk_pallas` semantics, which differ from it near the image edge
(ROADMAP.md Queue 3). So, as in tests/test_torch_frontend.py, LK is swapped
for the TPU kernel's semantics through a host callback into the port's
plain LK; every other stage of the JAX frontend runs unchanged. The JAX
process sees one CPU device, so `ba.distributed="auto"` is the
single-device solver, as on one card.

Prints one JSON line a run: ATE_sim3 (over the non-black frames for
blackout), resets, relocalizations, keyframes, BA solves and discards, the
statuses, and the blackout's scale ratio (median step-length ratio after
over before, the property of tests/test_relocalization.py).
Imports JAX: it runs where the JAX package runs, never on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from chip_smoke import blackout_scale_ratio, non_black, with_blackout
from ya_vo_tpu.config import VOConfig
from ya_vo_tpu.tracking import lk as jlk
from ya_vo_tpu.tracking.frontend import Frontend
from ya_vo_tpu.utils import synthetic
from ya_vo_tpu.viz import evaluation
from ya_vo_tpu_torch.tracking import lk_cuda


def tpu_semantics_lk(img0, img1, uv0, uv_init, mask, **kw):
    """`lk.auto_track` with the TPU kernel's semantics: a host callback
    into the port's plain LK."""
    def host(*arrays):
        out = lk_cuda.track(*(torch.as_tensor(np.array(a)) for a in arrays),
                            **kw)
        return tuple(x.numpy() for x in out)

    n = uv0.shape[0]
    shapes = (jax.ShapeDtypeStruct((n, 2), jnp.float32),
              jax.ShapeDtypeStruct((n,), jnp.bool_),
              jax.ShapeDtypeStruct((n,), jnp.float32))
    return jlk.FlowResult(*jax.pure_callback(host, shapes, img0, img1, uv0,
                                             uv_init, mask))


def run(name: str, frames, poses_gt, cam) -> dict:
    cfg = VOConfig()
    if name == "ba_off":
        cfg = dataclasses.replace(cfg, ba=dataclasses.replace(cfg.ba,
                                                              enabled=False))
    seq = with_blackout(frames) if name == "blackout" else list(frames)
    fe = Frontend(cfg, cam)
    t0 = time.perf_counter()
    traj = fe.run(seq, pipelined=True)
    out = dict(run=name, seconds=time.perf_counter() - t0,
               resets=fe.n_resets, relocalizations=fe.n_relocalizations,
               keyframes=sum(r.is_keyframe for r in fe.results),
               ba_solves=fe.n_ba_runs, ba_discarded=fe.n_ba_discarded,
               statuses=[r.status for r in fe.results])
    gt_cw = np.linalg.inv(poses_gt)
    if name == "blackout":
        keep = non_black(len(frames))
        out["ate_sim3"] = evaluation.ate_rmse(traj[keep], gt_cw,
                                              with_scale=True)
        out["scale_ratio"] = blackout_scale_ratio(traj, poses_gt)
    else:
        out["ate_sim3"] = evaluation.ate_rmse(traj, gt_cw, with_scale=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="ba_off,ba_on,blackout")
    args = ap.parse_args()
    frames, poses_gt, _, cam = synthetic.render_sequence(**chip_smoke.SEQ)
    jlk.auto_track = tpu_semantics_lk
    for name in args.runs.split(","):
        print(json.dumps(run(name, frames, poses_gt, cam)), flush=True)


if __name__ == "__main__":
    main()
