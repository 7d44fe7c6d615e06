"""Build and load the hand-written CUDA kernels, and count their launches.

Every `csrc/*.cu` file is compiled by its own `nvcc`, all started together,
and the objects are linked into one shared library with a plain C interface,
loaded with `ctypes`. The build happens at first use, into
`build/kernels/<hash>/` at the repository root, keyed by a hash of the
sources and flags, so a fresh checkout builds itself and an edited source
rebuilds. `-fmad=false` keeps the kernels' float arithmetic rounding at the
same places as the plain PyTorch versions (no fused multiply-adds), which is
what lets the FAST score map match to the last bit.

Each wrapper adds one to `LAUNCHES[name]` where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernels.
A wrapper called while a CUDA graph is being captured launches nothing: its
launch is recorded in the capture's own counts (`capturing`), and every
replay of the graph adds them to `LAUNCHES` (`count_replay`), so the counts
read what the card ran. `REPLAYS` counts the replays themselves.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]
KERNELS = ("fast_score", "fast_select", "hamming", "lk_level", "pose_gn")
# each wrapper's kernel function, as the profiler names its device events
DEVICE_NAMES = {"fast_score": "fast_score_kernel",
                "fast_select": "fast_select_kernel",
                "hamming": "hamming_kernel", "lk_level": "lk_pyramid_kernel",
                "pose_gn": "pose_gn_kernel"}

LAUNCHES = {name: 0 for name in KERNELS}
REPLAYS = {"graphs": 0}
# the launch counts of the capture under way in this thread, or None; one
# capture at a time in the process (PyTorch's rule for graph captures)
_capture = threading.local()
_capture_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
MAX_LK_LEVELS = 4


class LkLevels(ctypes.Structure):
    """`Levels` of csrc/lk_level.cu, passed by value: both pyramids' level
    pointers, their sizes and padded sizes, and the number of levels."""
    _fields_ = [("img0", _P * MAX_LK_LEVELS), ("img1", _P * MAX_LK_LEVELS),
                ("H", _I * MAX_LK_LEVELS), ("W", _I * MAX_LK_LEVELS),
                ("Hp", _I * MAX_LK_LEVELS), ("Wp", _I * MAX_LK_LEVELS),
                ("n", _I)]


_SIGNATURES = {
    # img, cand_score, cand_idx, count, H, W, threshold, arc_length,
    # harris_k, nms_radius, border, stream
    "yavo_fast_score": [_P, _P, _P, _P, _I, _I, _F, _I, _F, _I, _I, _P],
    # score, idx, count, K, W, uv, out_score, out_mask, stream
    "yavo_fast_select": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    # d1, d2, out, K1, K2, n_words, stream
    "yavo_hamming": [_P, _P, _P, _I, _I, _I, _P],
    # levels, uv0, seed, valid, out_uv, out_a, out_b, out_c, out_status,
    # N, iters, eps, min_eig, max_residual, rel_residual, mode, stream
    "yavo_lk_level": [LkLevels, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _F, _F, _F, _F, _I, _P],
    # T_init and its two strides, pts and its strides, uv and its strides,
    # mask and its stride, N, iters, fx, fy, cx, cy, huber_delta,
    # chi2_threshold, damping, out_pose, out_inliers, out_n_inliers,
    # out_cost, out_iters, stream
    "yavo_pose_gn": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I,
                     _F, _F, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    # the blocks of pose_gn's cluster (no arguments)
    "yavo_pose_gn_cluster_size": [],
}

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    REPLAYS["graphs"] = 0


@contextlib.contextmanager
def capturing():
    """Inside (a graph's capture in this thread), `launch` records each
    launch in the yielded counts instead of `LAUNCHES`. Captures in other
    threads wait. The garbage collector stays off until the capture ends:
    a collection inside it can free a dead frontend's graphs, whose memory
    pools go back with `cudaFree`, which invalidates a capture."""
    counts = {name: 0 for name in KERNELS}
    with _capture_lock:
        enabled = gc.isenabled()
        gc.disable()
        _capture.counts = counts
        try:
            yield counts
        finally:
            _capture.counts = None
            if enabled:
                gc.enable()


def count_replay(counts: dict) -> None:
    """One replay of a graph whose capture recorded `counts`."""
    for name, n in counts.items():
        LAUNCHES[name] += n
    REPLAYS["graphs"] += 1


def library_path(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(Path(csrc).glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libyavo_kernels.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(csrc: Path = CSRC) -> Path:
    """Compile `csrc`/*.cu (by default this package's) into the hashed
    library unless it already exists: one nvcc a source, in parallel, then
    one link."""
    out = library_path(csrc)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in sorted(Path(csrc).glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(lib, out)
    return out


def load_library(path: Path) -> ctypes.CDLL:
    """A built kernel library with its functions' argument types set (of
    those it has: an older checkout's library may lack some)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES.items():
        if not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call). Setting `_lib` to
    another `load_library` result makes the wrappers launch its kernels
    (`port_pose_gn.py` runs two trees' K4 in one process so)."""
    global _lib
    if _lib is None:
        _lib = load_library(build())
    return _lib


def launch(name: str, *args) -> None:
    """Call `yavo_<name>` on the current stream, raise on a CUDA error, and
    count the launch (in the capture's counts during a capture)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), f"yavo_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    counts = getattr(_capture, "counts", None)
    (LAUNCHES if counts is None else counts)[name] += 1


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
               contiguous: bool = True) -> None:
    """Raise unless `t` is a CUDA tensor of `dtype` and `shape` (None in
    `shape` matches any size), contiguous unless `contiguous` is False."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
