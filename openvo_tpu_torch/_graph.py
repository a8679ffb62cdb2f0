"""CUDA graphs: the port's counterpart of ``jax.jit(fn, donate_argnums=(0,))``.

JAX compiles each step it runs into one program and donates the state to
it: the odometer's step, cached per (camera, config, color)
(``openvo_tpu/models/stereo_odometer.py:349-360``), the rig's
(``openvo_tpu/parallel/rig.py:45-46``) and each chunk of the stream
(``openvo_tpu/parallel/stream.py:52-72``), and the camera's ``compute_3d``
without state (``openvo_tpu/models/stereo_camera.py:181-188``). Here
:func:`capture` wraps such a step ``fn(state, *inputs) -> (state',
*outs)``; a step without state takes and returns ``()``. On its first
call on the card it

- allocates static buffers for the state and the inputs;
- runs ``fn`` once eagerly on the current stream, the one its replays
  run on (the warm-up): every one-time call happens there, not in the
  capture (the kernel library's build and load, each kernel's first
  launch and shared-memory attribute, H6's tap tables, each
  ``ops/_dispatch.device_constant``'s upload). Run on a side stream, the
  step left the card slow for seconds: every later kernel of the process
  started about 0.35 us later on an H100, for 0.6 to 18 s;
- captures one call into a ``torch.cuda.CUDAGraph`` that ends by copying
  the new state into the static state buffers;

and replays it. Each later call copies its inputs into the static buffers
(and the state, unless it is the static one the last call returned) and
replays the graph: one launch for the whole step, no host sync.

A ``torch.Generator`` in the state (the mono odometer's sampler) is not
copied: the graph registers it (``CUDAGraph.register_generator_state``),
so each replay draws the numbers the next eager call would draw and
advances it as that call would; the warm-up's draws are undone (its state
saved and restored around the warm-up), and a state passed in with
another generator hands its state over (``set_state``).

Donation: the state a call returns is the static buffers, and its other
outputs live in the graph's memory pool. Both are valid until the next call
of the same step, as JAX's donated state is invalid once it is passed on. A
caller copies what it keeps.

A failed capture raises, and so does an op that syncs with the host while
it is captured (CUDA refuses it): nothing falls back to the eager run on
its own. :func:`disable_capture`, the counterpart of ``jax.disable_jit()``,
runs the steps eagerly on the card, so that a captured run can be held
against the eager one; on the CPU every step runs eagerly.

Tracing (``openvo_tpu_torch/trace.py``): a call records the spans
``ovo.upload`` (the copies into the static buffers) and ``ovo.launch``
(the replay); the first call's warm-up and capture are ``ovo.capture``,
with ``ovo.warmup`` and ``ovo.graph_capture`` inside, recorded always. A
step places the device's stage marks in its graph with :func:`mark`; the
capture adds a last ``state`` mark after the static-buffer copies.
"""

from __future__ import annotations

import contextlib
import gc

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from openvo_tpu_torch import trace

_disabled = 0
_marks = None   # the (stage, event) list of the graph being captured


@contextlib.contextmanager
def disable_capture():
    """Run every captured step of the port eagerly inside the block."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def capture_enabled() -> bool:
    return _disabled == 0


def mark(stage: str) -> None:
    """End the device stage ``stage`` of the step being captured, begun at
    the mark before it (the step's first mark, ``start``, begins none): a
    timing event recorded on the capture stream, an event-record node of
    the graph (``openvo_tpu_torch/trace.py`` reads it after a replay).
    Outside a graph's capture (the CPU, the warm-up, ``disable_capture``,
    ``make_fx``) nothing."""
    if _marks is not None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        _marks.append((stage, event))


def _signature(inputs):
    return tuple((tuple(x.shape), x.dtype) for x in inputs)


def _is_generator(leaf) -> bool:
    return isinstance(leaf, torch.Generator)


def _static(leaf):
    """A static buffer for a state leaf: a clone of a tensor; a generator
    stays itself (the graph registers it)."""
    return leaf if _is_generator(leaf) else torch.clone(leaf)


class CapturedStep:
    """``fn`` captured on its first call on the card and replayed after
    (see the module docstring). ``marks`` holds the graph's stage marks
    (``trace.Marks``), or None where ``fn`` places none."""

    def __init__(self, fn, device=None):
        self.fn = fn
        self.device = device   # where the buffers go; else the state's
        self.holder = None     # a weak reference to the odometer whose
                               # state the static buffers hold
        self.graph = None
        self.state = None      # the static state buffers
        self.inputs = None     # the static input buffers
        self.outs = None
        self.marks = None

    def __call__(self, state, *inputs):
        inputs = [torch.as_tensor(x) for x in inputs]
        first = self.graph is None
        if first:
            with trace.span("ovo.capture", always=True):
                self._capture(state, inputs)
        elif _signature(inputs) != _signature(self.inputs):
            raise ValueError(f"captured for inputs {_signature(self.inputs)}"
                             f", called with {_signature(inputs)}")
        with trace.span("ovo.upload"):
            if not first and state is not self.state:
                for dst, src in zip(tree_leaves(self.state),
                                    tree_leaves(state)):
                    if not _is_generator(dst):
                        dst.copy_(src)
                    elif src is not dst:
                        dst.set_state(src.get_state())
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src, non_blocking=True)
        with trace.span("ovo.launch"):
            trace.launched(self.marks, self.device)
            self.graph.replay()
        return (self.state, *self.outs)

    def _capture(self, state, inputs):
        global _marks
        dev = self.device = (torch.device(self.device)
                             if self.device is not None
                             else tree_leaves(state)[0].device)
        self.state = tree_map(_static, state)
        gens = [g for g in tree_leaves(self.state) if _is_generator(g)]
        self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in inputs]
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        drawn = [g.get_state() for g in gens]
        with trace.span("ovo.warmup", always=True):
            self.fn(self.state, *self.inputs)
        torch.cuda.synchronize(dev)
        for g, st in zip(gens, drawn):   # the warm-up draws nothing
            g.set_state(st)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        marks = _marks = []
        # The collector must not run inside the capture: a graph it frees
        # there (a dead cycle of an earlier step's) destroys its executable,
        # which invalidates the capture under way.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with trace.span("ovo.graph_capture", always=True), \
                    torch.cuda.graph(graph):
                self._record(marks)
        finally:
            _marks = None
            if collecting:
                gc.enable()
        torch.cuda.synchronize(dev)
        self.graph = graph
        self.marks = trace.Marks(marks) if marks else None

    def _record(self, marks):
        """The captured body: the step, then the new state copied into
        the static buffers, then (where the step placed marks) the last
        ``state`` mark."""
        new_state, *outs = self.fn(self.state, *self.inputs)
        static, spec = tree_flatten(self.state)
        new, new_spec = tree_flatten(new_state)
        if new_spec != spec:
            raise TypeError(f"the step returned a state of another "
                            f"structure: {new_spec} for {spec}")
        if any(_is_generator(d) and s is not d
               for s, d in zip(new, static)):
            raise TypeError("the step returned another generator than "
                            "its state's")
        # a leaf that aliases a static buffer is copied before any
        # buffer is written
        ptrs = {t.data_ptr() for t in static if not _is_generator(t)}
        new = [s if s is d or s.data_ptr() not in ptrs else s.clone()
               for s, d in zip(new, static)]
        for dst, src in zip(static, new):
            if src is not dst:
                dst.copy_(src)
        if marks:
            mark("state")
        self.outs = outs


def capture(fn, device=None) -> CapturedStep:
    """``fn(state, *inputs) -> (state', *outs)`` as a :class:`CapturedStep`:
    the counterpart of ``jax.jit(fn, donate_argnums=(0,))``. Its buffers go
    on ``device``, or on the state's device where it is None (a step
    without state names its device). The caller runs ``fn`` itself on the
    CPU and under :func:`disable_capture`."""
    return CapturedStep(fn, device)
