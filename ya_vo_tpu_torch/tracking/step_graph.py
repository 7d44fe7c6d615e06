"""The fused tracking step as two CUDA graphs, captured once and replayed on
every tracking dispatch.

Port of `ya_vo_tpu/tracking/frontend.py` `_build_track_step`: the JAX
frontend compiles the steady-state frame into two programs, `step`
(extraction, then the step body) and `step_pre` (the body on a reused
extraction, for the redo of an in-flight frame), each one device dispatch,
with the frame number and the map's free landmark capacity traced as
scalars. Here they are `torch.cuda.CUDAGraph`s, "fresh" and "redo",
captured from `Frontend._extract` and `Frontend._step_body` on static
buffers; a replay costs the host one `cudaGraphLaunch` where the eager step
issues some 330 launches.

Ownership. A graph reads its inputs from, and writes its outputs to, the
same addresses on every replay:
- inputs: one static buffer for each of `Frontend._step_args`' 18 values
  (the anchor keyframe's image, the frame, the LK template image, the 13
  tensors of the track table and keyframe context, the frame number and
  the free capacity, 0-d int64) and, for the redo, the reused keypoints'
  positions and mask and their descriptors. Before a replay each argument
  whose storage is not its buffer is copied in (after a state push, a BA
  correction composed on the device, a checkpoint load or a throwaway
  chain; the frame, its template on a redo and the two scalars always);
- the next state: the graph ends by writing it back into its own input
  buffers (the frame into the template's), so the frontend's device chain
  (`DEVICE_KEYS`) is the buffers themselves and the steady state copies
  nothing in but the frame and the scalars;
- outputs: the record (`RECORD_KEYS`) stays graph-owned, and `_pull`
  queues its copies to the host on the same stream before the next replay
  can start; a fresh dispatch's keypoints and descriptors, which the host
  keeps for later redos, keyframes and resets, are copied out.

Capture happens once a frontend, at its first tracking dispatch (after the
bootstrap, or in `precompile`): that dispatch runs eagerly on the capture
stream as the warm-up (the kernels' build and module loads,
`fast_select`'s shared-memory attribute, the cuBLAS and cuSOLVER handles),
then both graphs are captured on that stream with
`capture_error_mode="thread_local"`, so the window BA's worker thread may
issue work of its own meanwhile. Capture launches nothing: `_build`
records each kernel's launches in the graph's counts and adds them to
`_build.LAUNCHES` on every replay. A capture or replay that fails raises;
nothing falls back to the eager step. The graphs keep the kernel library
they captured: when `_build`'s library is swapped they are dropped and the
next dispatch captures again.

On the CPU nothing is captured: a "replay" runs the body on the same
buffers, writes the state back and leaves its outputs in static tensors
as a graph would, so the CPU tests exercise the buffer handling above.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ya_vo_tpu_torch import _build
from ya_vo_tpu_torch.features.fast import Keypoints

# `_step_body`'s state outputs, each with the index of the `_step_args`
# buffer it is written back into: the track table and keyframe context, the
# anchor keyframe's image (0) and the next dispatch's LK template (2), which
# is the frame (1)
STATE_TO_ARG = (4, 5, 6, 7, 8, 9, 10, 11, 12, 0, 13, 14, 3, 15, 2)

_tls = threading.local()


def tap(t: torch.Tensor, fn) -> None:
    """Hand `fn` the tensor `t` each time the code that made it runs: now,
    outside a capture; inside a step graph's capture, after every replay of
    that graph, as a copy (the next replay overwrites `t`)."""
    taps = getattr(_tls, "taps", None)
    if taps is None:
        fn(t)
    else:
        taps.append((t, fn))


@contextlib.contextmanager
def _tapping():
    _tls.taps = taps = []
    try:
        yield taps
    finally:
        _tls.taps = None


def _nested(out):
    """(kp, desc, record) with every tensor cloned."""
    kp, desc, record = out
    return (Keypoints(*(None if t is None else t.clone() for t in kp)),
            desc.clone(), tuple(t.clone() for t in record))


def _copy_nested(dst, src) -> None:
    for d, s in zip((*dst[0], dst[1], *dst[2]), (*src[0], src[1], *src[2])):
        if d is not None:
            d.copy_(s)


class _Graph:
    """One captured variant: the graph (None on the CPU), its static
    outputs (kp, desc, record), its kernels' launches a replay and its
    taps."""

    def __init__(self, graph, out, counts, taps):
        self.graph, self.out, self.counts, self.taps = graph, out, counts, taps


class StepGraphs:
    """The fresh and redo step of one frontend, captured once (`capture`)
    and replayed by `dispatch`."""

    def __init__(self, fe):
        self.fe = fe
        self.bufs = None         # `_step_args`' 18 static buffers
        self.pre_bufs = None     # the redo's (kp uv, kp mask, desc)
        self.variants = {}
        self.stream = (torch.cuda.Stream(fe.device)
                       if fe.device.type == "cuda" else None)
        self._lib = None
        self._prev_src = None    # the frame whose pixels buffer 2 holds

    @property
    def ready(self) -> bool:
        """Captured, with the kernel library that is loaded now."""
        if self.bufs is None:
            return False
        if self.stream is not None and self._lib is not _build._lib:
            self.drop()
            return False
        return True

    def drop(self) -> None:
        self.variants, self.bufs, self.pre_bufs = {}, None, None
        self._prev_src = None

    def warm_stream(self):
        """The context of the first, eager dispatch: on the capture stream
        on the card (ordered after the current stream and before what
        follows it), else nothing."""
        if self.stream is None:
            return contextlib.nullcontext()
        return _on_side_stream(self.stream)

    def source(self, prev_img: torch.Tensor) -> torch.Tensor:
        """The frame whose pixels `prev_img` holds: the caller's frame of
        the last replay where `prev_img` is the template's buffer."""
        if (self.bufs is not None and prev_img is not None
                and prev_img.data_ptr() == self.bufs[2].data_ptr()):
            return self._prev_src
        return prev_img

    # ------------------------------------------------------------------ #
    def capture(self, args, kp, desc) -> None:
        """Static buffers shaped as `args` (`_step_args`' values) and the
        extraction (kp, desc) of the dispatch just made, then both
        variants: on the card, captured as graphs; on the CPU, their static
        outputs at the first run."""
        self.bufs = [torch.empty_like(a) for a in args]
        self.pre_bufs = [torch.empty_like(t) for t in (kp.uv, kp.mask, desc)]
        self.variants = {}
        if self.stream is None:
            return
        self._lib = _build.library()
        for name in ("fresh", "redo"):
            graph = torch.cuda.CUDAGraph()
            with _build.capturing() as counts, _tapping() as taps:
                with torch.cuda.graph(graph, stream=self.stream,
                                      capture_error_mode="thread_local"):
                    out = self._body(name == "redo")
            self.variants[name] = _Graph(graph, out, counts, taps)

    def _body(self, redo: bool):
        """The step on the static buffers, the next state written back into
        them; returns (kp, desc, record)."""
        fe, b = self.fe, self.bufs
        if redo:
            uv, mask, desc = self.pre_bufs
            kp = Keypoints(uv=uv, score=None, mask=mask)
        else:
            kp, desc = fe._extract(b[1])
        state_out, record = fe._step_body(kp, desc, *b)
        for i, t in zip(STATE_TO_ARG, state_out):
            if t.data_ptr() != b[i].data_ptr():
                b[i].copy_(t)
        return kp, desc, tuple(record)

    def _copy_in(self, dst, src) -> None:
        for i, (d, s) in enumerate(zip(dst, src)):
            if s.data_ptr() == d.data_ptr():
                continue
            if s.shape != d.shape or s.dtype != d.dtype or \
                    s.device != d.device:
                raise ValueError(
                    f"step graph input {i}: {tuple(s.shape)} {s.dtype} on "
                    f"{s.device}, captured as {tuple(d.shape)} {d.dtype} "
                    f"on {d.device}")
            d.copy_(s)

    def dispatch(self, args, pre=None):
        """One dispatch on `args` (`_step_args`' values), fresh or with the
        reused extraction `pre` = (kp, desc): (kp, desc, state_out, record)
        as `_step_body` gives them, the state being the static buffers and
        the record graph-owned until the next replay."""
        redo = pre is not None
        self._copy_in(self.bufs, args)
        if redo:
            self._copy_in(self.pre_bufs, (pre[0].uv, pre[0].mask, pre[1]))
        v = self.variants.get("redo" if redo else "fresh")
        if self.stream is not None:
            v.graph.replay()
            _build.count_replay(v.counts)
            for t, fn in v.taps:
                fn(t.clone())
        else:
            out = self._body(redo)
            if v is None:
                v = self.variants["redo" if redo else "fresh"] = _Graph(
                    None, _nested(out), None, ())
            else:
                _copy_nested(v.out, out)
        kp, desc, record = v.out
        if redo:
            kp, desc = pre
        else:
            kp = Keypoints(*(t.clone() for t in kp))
            desc = desc.clone()
        self._prev_src = args[1]
        state_out = tuple(self.bufs[i] for i in STATE_TO_ARG)
        return kp, desc, state_out, record


@contextlib.contextmanager
def _on_side_stream(stream):
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        yield
    cur.wait_stream(stream)
