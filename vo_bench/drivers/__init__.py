"""The traffic drivers: each mix's closed or open loop, found by name.

A traffic mix (`vo_bench/traffic/<mix>.json`) names its driver under
`"driver"`; the harness loads `vo_bench/drivers/<driver>.py` from the
checkout's own `vo_bench/` (`run.load_driver`) and calls its

    drive(run, routes, make_frontend, audit, tracer, record_keys, seconds)

once, after its own set-up. So a new cell, metric or driver is new files
and entries, not an edit. The contract:

- `run` is the run's record (`run.Run`): `run.spec` the cell (its
  configuration, `run.spec.traffic` the mix's parameters, `run.spec.here`
  this checkout's `vo_bench/`), `run.device` the run's torch device (a
  driver that builds its sessions through another entry point, such as
  the CLI, hands it on), `run.setup` the seconds of each set-up phase so
  far. `routes` are the generator's routes (`generator.make`: frames as
  host uint8 arrays and their ground truth), `make_frontend()` a fresh
  `create_frontend` session of the configuration, `audit` the comparison's
  sampler, `tracer` the run's `run.Tracer`, `record_keys` the program's
  `RECORD_KEYS`, `seconds` the window's length.
- Set-up first: the driver warms every shape its traffic uses (a warm
  session) and may run set-up steps of its own, such as writing an image
  tree; it records each step's seconds in `run.setup` under a key of its
  own. All of it falls inside `setup_s`.
- Then the window: `tracer.start()`, `t0 = time.perf_counter()`,
  `run.setup_s = t0 - T_PROCESS` (the process's start, from the harness
  module `vo_bench.run`); until `t0 + seconds` it drives
  fresh sessions, each handed to `audit.attach(fe, session, record_keys)`
  before its first frame, and stops handing frames at the deadline.
- It counts into `run`: `attempted` (frames handed), `failed` (of those,
  no finite pose), `frames_done`, `create_ms` (each session's
  construction), `counters` (the harness's `_count(run, fe)` a session),
  `trajectories` (poses returned beside the route's ground truth) and,
  while `tracer.on`, `traced_frames`. `run.window_s` runs from `t0` to the
  return of the last call; then `tracer.stop(t0)`.
- It imports the harness (`vo_bench.run`: `T_PROCESS`, `_count`,
  `_finite`) inside `drive`, never at the top of its file, so the two
  never import each other while loading.
"""
