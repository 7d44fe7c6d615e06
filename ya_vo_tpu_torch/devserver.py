"""Persistent dev exec server: keeps a warm Python + torch process (its CUDA
context made) and runs job files on demand.

    python -m ya_vo_tpu_torch.devserver [JOBDIR] [--idle-timeout S]
                                        [--exit-after S] [--device cpu]
    tools/run_job.sh job.py 600 JOBDIR      # submit a job, print its output

Port of `tools/devserver.py`, with its protocol, which `tools/run_job.sh`
speaks: a job is `<JOBDIR>/<stem>.py`; the server runs the oldest one
without a `<stem>.done`, writes its output and a closing
`[devserver] exit=<code> wall=<s>s` line to `<stem>.out`, then its exit code
to `<stem>.done`. It writes `<JOBDIR>/_ready` once warm and its pid to
`<JOBDIR>/_devserver.pid` (removed at exit). Each job runs in a fresh
namespace as `__main__` in the same process, so imports and the kernels'
library stay warm; `ya_vo_tpu_torch` and every other module loaded from the
repository are dropped from `sys.modules` before a job, so code edits are
picked up.

A server left running holds the card (the JAX tool's postmortem: a
forgotten server held the single chip, and the next fresh process hung at
backend init). So it exits after `--idle-timeout` seconds without a job
(default 20 min) and after `--exit-after` seconds in all (default 3 h).
The default JOBDIR is build/jobs in the repository.
"""

from __future__ import annotations

import argparse
import atexit
import io
import os
import sys
import time
import traceback

import torch

from ya_vo_tpu_torch import require_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_JOBDIR = os.path.join(REPO, "build", "jobs")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jobdir", nargs="?", default=DEFAULT_JOBDIR)
    ap.add_argument("--idle-timeout", type=float, default=1200.0,
                    help="exit after this many seconds without a job")
    ap.add_argument("--exit-after", type=float, default=3 * 3600.0,
                    help="unconditional lifetime cap in seconds")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA context is made at "
                         "start) or cpu")
    return ap.parse_args(argv)


def write_pidfile(pidfile: str) -> None:
    with open(pidfile, "w") as f:
        f.write(f"{os.getpid()} started={time.time():.0f}\n")

    def cleanup():
        try:
            os.remove(pidfile)
        except OSError:
            pass

    atexit.register(cleanup)


def reload_repo_modules() -> None:
    """Drop the port's modules and every other module loaded from the
    repository (test modules too), so the next import runs them afresh."""
    for name, mod in list(sys.modules.items()):
        f = getattr(mod, "__file__", None) or ""
        if name.startswith("ya_vo_tpu_torch") or f.startswith(REPO):
            del sys.modules[name]


def run_job(path: str) -> tuple:
    """(exit code, output) of the job file at `path`."""
    buf = io.StringIO()
    old_out, old_err = sys.stdout, sys.stderr
    code = 0
    try:
        with open(path) as f:
            src = f.read()
        reload_repo_modules()
        sys.stdout = sys.stderr = buf
        ns = {"__name__": "__main__", "__file__": path}
        exec(compile(src, path, "exec"), ns)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else int(e.code is not None)
    except Exception:
        traceback.print_exc()
        code = 1
    finally:
        sys.stdout, sys.stderr = old_out, old_err
    return code, buf.getvalue()


def serve(a: argparse.Namespace) -> None:
    if require_device(a.device).type == "cuda":
        torch.zeros(1, device=a.device)        # make the CUDA context
    os.makedirs(a.jobdir, exist_ok=True)
    write_pidfile(os.path.join(a.jobdir, "_devserver.pid"))
    print(f"[devserver] watching {a.jobdir} (pid={os.getpid()}, "
          f"idle-timeout={a.idle_timeout:.0f}s, "
          f"exit-after={a.exit_after:.0f}s)", flush=True)
    with open(os.path.join(a.jobdir, "_ready"), "w") as f:
        f.write("ready")
    t_start = t_last_job = time.time()
    while True:
        now = time.time()
        if now - t_last_job > a.idle_timeout:
            print(f"[devserver] idle {now - t_last_job:.0f}s > "
                  f"{a.idle_timeout:.0f}s: exiting (frees the card)",
                  flush=True)
            return
        if now - t_start > a.exit_after:
            print(f"[devserver] lifetime cap {a.exit_after:.0f}s reached: "
                  f"exiting (frees the card)", flush=True)
            return
        jobs = sorted(
            f for f in os.listdir(a.jobdir)
            if f.endswith(".py") and not os.path.exists(
                os.path.join(a.jobdir, f[:-3] + ".done")))
        if not jobs:
            time.sleep(0.2)
            continue
        name = jobs[0]
        stem = os.path.join(a.jobdir, name[:-3])
        t0 = time.time()
        code, out = run_job(os.path.join(a.jobdir, name))
        dt = time.time() - t0
        t_last_job = time.time()
        with open(stem + ".out", "w") as f:
            f.write(out)
            f.write(f"\n[devserver] exit={code} wall={dt:.2f}s\n")
        with open(stem + ".done", "w") as f:
            f.write(str(code))
        print(f"[devserver] {name} -> exit={code} ({dt:.1f}s)", flush=True)


def main(argv=None) -> None:
    serve(parse(argv))


if __name__ == "__main__":
    main()
