"""drives: logged drives in a closed loop. The routes in order, each through
`Frontend.run(frames, pipelined=True)` of a fresh `create_frontend`
session, until the window closes (the frame source stops handing frames
at the deadline); the window ends at the return of the last call."""

from __future__ import annotations

import gc
import time
import traceback


def drive(run, routes, make_frontend, audit, tracer, record_keys,
          seconds: float) -> None:
    """The closed loop over logged drives, for a window of `seconds`."""
    import numpy as np
    import torch

    from vo_bench.run import T_PROCESS, _count, _finite

    warm = run.spec.traffic["warm_frames"]
    t = time.perf_counter()
    fe = make_frontend()
    fe.run(routes[0].frames[:warm], pipelined=True)
    fe.precompile()
    del fe
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run.setup["warm_session_s"] = time.perf_counter() - t
    tracer.start()
    t0 = time.perf_counter()
    run.setup_s = t0 - T_PROCESS
    deadline = t0 + seconds
    t_end = t0
    session = 0
    while time.perf_counter() < deadline:
        route = routes[session % len(routes)]
        tc = time.perf_counter()
        fe = make_frontend()
        run.create_ms.append((time.perf_counter() - tc) * 1e3)
        audit.attach(fe, session, record_keys)
        handed = [0]

        def frames(route=route, handed=handed):
            for img in route.frames:
                if time.perf_counter() >= deadline:
                    return
                handed[0] += 1
                if tracer.on:
                    run.traced_frames.append(img)
                yield img

        try:
            traj = fe.run(frames(), pipelined=True)
            ok = sum(_finite(p) for p in traj)
        except Exception:
            traceback.print_exc()
            ok = 0
        t_end = time.perf_counter()
        run.attempted += handed[0]
        run.failed += handed[0] - ok
        run.frames_done += ok
        _count(run, fe)
        n = len(fe.trajectory)
        if n:
            run.trajectories.append((np.stack(fe.trajectory),
                                     route.poses_wc[:n]))
        session += 1
        del fe
    run.window_s = t_end - t0
    tracer.stop(t0)
