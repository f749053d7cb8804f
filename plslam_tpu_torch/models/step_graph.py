"""CUDA-graph replay of a per-frame step: the port's counterpart of `jax.jit`
around a step of the JAX package's `System`.

A step is a function of tensors that never waits for the device (tracking,
extraction, and both in one). On the card its ~25k small kernels cost ~20 us
of host dispatch each, while the device finishes each in ~1.5 us; a CUDA
graph records them once and launches them with one call.

`StepGraphs(device)` holds one System's graphs: one memory pool shared by all
of them, and the counts of captures and replays. `StepGraphs.step(fn, bound)`
wraps `fn(*args, **kwargs)`:

- **The cache key.** The structure of the arguments (which optional ones are
  None, the values of the non-tensor ones), the shape and dtype of every
  tensor, and the identity (`data_ptr`, shape, dtype) of every tensor of the
  `MapState` at position `bound`. A graph bakes in pointers: the map's
  tensors are read and updated in place by address, and K1's tensor-memory
  maps are encoded on the host into its kernel parameters. So a map whose
  storage changed (growth, a reset, a loop closer returning a new map)
  drops every graph of the step and the next call captures anew.
- **A new key** runs the call eagerly on a side stream (that warms the step
  up: library handles, kernel attributes, workspaces; its result is the
  call's result), then captures the step into a graph on copies of the
  inputs, its static buffers. Capturing runs nothing.
- **A known key** copies the tensor inputs into the static buffers, replays
  the graph, and returns clones of the outputs. `clone=False` returns the
  static outputs themselves: all graphs of a `StepGraphs` share one pool, so
  a later graph may hold its temporaries where an earlier one keeps its
  outputs, and they are valid until any graph of this `StepGraphs` replays.
- **Counts.** `captures`, the host seconds they took (`capture_s`, the
  eager warm-up included) and `replays`; the `launches` of each wrapper
  registered with `counted` grow on replay by the launches its capture
  recorded, and the capture itself counts none.

On the CPU, or with `enabled=False`, the step calls `fn` directly. On CUDA a
failed capture or replay raises: nothing falls back to eager execution.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.utils._pytree as pytree

# the kernel wrappers whose `launches` count their kernel's launches
COUNTED: list = []


def counted(fn):
    """Registers the wrapper `fn`, whose `launches` attribute (set to 0
    here) it raises by one per kernel launch: a replay adds the launches
    its capture recorded."""
    fn.launches = 0
    if fn not in COUNTED:
        COUNTED.append(fn)
    return fn


_BOUND = object()   # stands in for the bound map among the arguments


def signature(args, kwargs):
    """(key, leaves, spec, tensors) of a call: its flattened arguments and
    their structure; the tensors among the leaves; and the key, hashable:
    the structure, each tensor's shape and dtype, each other leaf's value."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    tensors = [x for x in leaves if torch.is_tensor(x)]
    key = (spec, tuple(("T", tuple(x.shape), x.dtype) if torch.is_tensor(x)
                       else x for x in leaves))
    return key, leaves, spec, tensors


def rebuild(leaves, spec, tensors, bound=None):
    """The (args, kwargs) of `signature` with its tensors replaced, in
    order, by `tensors` and the bound map put back."""
    it = iter(tensors)
    return pytree.tree_unflatten(
        [next(it) if torch.is_tensor(x) else bound if x is _BOUND else x
         for x in leaves], spec)


def tensors_of(x) -> list:
    """The tensors of the structure x, in flattening order."""
    return [t for t in pytree.tree_leaves(x) if torch.is_tensor(t)]


def identity(ms) -> tuple:
    """(data_ptr, shape, dtype) of every tensor of a `MapState`."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in
                 (getattr(ms, f.name) for f in dataclasses.fields(ms)))


@dataclasses.dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph
    static_in: list
    static_out: object
    recorded: tuple      # launches per counted kernel in one replay


class StepGraphs:
    """The CUDA graphs of one System's steps: one memory pool, the counts of
    captures and replays. Disabled off CUDA."""

    def __init__(self, device, enabled: bool = True):
        self.device = torch.device(device)
        self.enabled = bool(enabled) and self.device.type == "cuda"
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self._steps: list = []
        self._pool = None
        self._side = None

    def step(self, fn, bound=None) -> "StepGraph":
        """`fn` as a graphed step; `bound` is the position of the `MapState`
        argument that the graph reads and updates in place."""
        self._steps.append(StepGraph(self, fn, bound))
        return self._steps[-1]

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _capture_pool(self):
        """The shared pool, or a new one when no graph lives: a pool whose
        last graph was destroyed cannot take another capture."""
        if self._pool is None or not any(s._entries for s in self._steps):
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool


class StepGraph:
    """One step's graphs, one per key (see the module docstring)."""

    def __init__(self, graphs: StepGraphs, fn, bound=None):
        self.graphs, self.fn, self.bound = graphs, fn, bound
        self._entries: dict = {}
        self._bound_id = None

    def __call__(self, *args, clone: bool = True, **kwargs):
        g = self.graphs
        if not g.enabled:
            return self.fn(*args, **kwargs)
        ms = None
        if self.bound is not None:
            ms = args[self.bound]
            bid = identity(ms)
            if bid != self._bound_id:    # the old graphs bake old pointers
                self._entries.clear()
                self._bound_id = bid
            args = args[:self.bound] + (_BOUND,) + args[self.bound + 1:]
        key, leaves, spec, tensors = signature(args, kwargs)
        entry = self._entries.get(key)
        if entry is None:
            return self._capture(key, leaves, spec, tensors, ms, clone)
        for dst, src in zip(entry.static_in, tensors):
            dst.copy_(src)
        entry.graph.replay()
        for fn, n in zip(COUNTED, entry.recorded):
            fn.launches += n
        g.replays += 1
        return pytree.tree_map_only(torch.Tensor, torch.clone,
                                    entry.static_out) if clone \
            else entry.static_out

    def _capture(self, key, leaves, spec, tensors, ms, clone: bool):
        t0 = time.perf_counter()
        g = self.graphs
        side = g._side_stream()
        cur = torch.cuda.current_stream(g.device)
        # this call, eagerly, on the side stream: the warm-up
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            args, kwargs = rebuild(leaves, spec, tensors, ms)
            out = self.fn(*args, **kwargs)
        cur.wait_stream(side)
        static_in = [t.clone() for t in tensors]
        args, kwargs = rebuild(leaves, spec, static_in, ms)
        counts = [fn.launches for fn in COUNTED]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=g._capture_pool()):
                static_out = self.fn(*args, **kwargs)
        finally:
            recorded = tuple(fn.launches - c for fn, c in zip(COUNTED, counts))
            for fn, c in zip(COUNTED, counts):
                fn.launches = c
        self._entries[key] = _Entry(graph, static_in, static_out, recorded)
        if not clone:
            # the caller reads the static outputs: fill them with this
            # call's
            for dst, src in zip(tensors_of(static_out), tensors_of(out)):
                dst.copy_(src)
            out = static_out
        g.captures += 1
        g.capture_s += time.perf_counter() - t0
        return out
