"""The rescue ladder's gate kernel and the CUDA graph with conditional nodes
that holds a device-mode ladder (``csrc/ladder_graph.cu``).

The reference runs each later rung of its k-doubling ladder under
``lax.cond(any(failed))`` on the device (``repro/core/windowing.py``).  A
session's device-mode executable (``serve.graphs.GraphedStep``) does the
same in one graph a dispatch, built node by node with :class:`CondGraph`:
rung 0's captured graphs as child nodes, then one gate kernel a pair
shard and an IF conditional node whose body holds rung 1's captures and,
nested in it, rung 2's gates and IF node, and so on.  The gate
(``ladder_gate_kernel``) reads a shard's ``failed`` lanes and raises the
IF node's condition where one is set; the condition starts at 0 at every
launch.  So the card decides which rungs run, and the host launches once
and never waits.  Nesting each rung in the one before costs the launch
less host time than a flat chain of IF nodes (0.51 against 0.67 ms for a
16 kbp ladder of three rungs on an H100, ``tools/torch_launch_cost.py``).

``ladder_gate`` is the gate kernel alone (``out[0] = any(failed)``, no
condition), its plain PyTorch version ``ladder_gate_plain``; on a CPU
tensor the wrapper runs the plain version, on a CUDA tensor it launches
the kernel or raises.  ``LAUNCHES`` counts the gate's launches: one a
wrapper call, a graph's top-level gate nodes at each of its launches
(``CondGraph.launch``), and the gates in the bodies that ran as their
caller learns it (``serve.graphs.GraphedStep.count_rungs``).  Nothing
here builds or loads the library at import.
"""
from __future__ import annotations

import ctypes
import threading
import weakref

import torch

LAUNCHES = {"ladder_gate": 0}
PLAIN_CALLS = {"ladder_gate": 0}
_LOCK = threading.Lock()


def _bump(counts: dict, n: int = 1) -> None:
    with _LOCK:
        counts["ladder_gate"] += n


def add_launches(n: int) -> None:
    """Count `n` gate launches a graph ran (its top-level gates at a
    launch; the gates of the bodies that ran, as their caller learns
    it)."""
    _bump(LAUNCHES, n)


def reset_counts() -> None:
    with _LOCK:
        LAUNCHES["ladder_gate"] = PLAIN_CALLS["ladder_gate"] = 0


def _library():
    from .build import load_library
    return load_library()


def _check(lib, what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.genasm_error_string(rc).decode()})")


def ladder_gate_plain(failed: torch.Tensor) -> torch.Tensor:
    """The gate's plain version: (1,) int32, 1 where any lane of `failed`
    is set, on its device, no host sync."""
    return failed.any().to(torch.int32).reshape(1)


def ladder_gate(failed: torch.Tensor) -> torch.Tensor:
    """The gate kernel alone on one shard's ``failed`` ((B,) bool): (1,)
    int32, 1 where any lane is failed."""
    if failed.dtype != torch.bool or failed.dim() != 1 or \
            not failed.is_contiguous():
        raise ValueError(f"failed must be a contiguous (B,) bool tensor, "
                         f"got {failed.dtype} {tuple(failed.shape)}")
    if failed.device.type == "cpu":
        _bump(PLAIN_CALLS)
        return ladder_gate_plain(failed)
    if failed.device.type != "cuda":
        raise ValueError(f"no kernel and no plain version for device "
                         f"{failed.device}")
    out = torch.empty(1, dtype=torch.int32, device=failed.device)
    lib = _library()
    with torch.cuda.device(failed.device):
        stream = torch.cuda.current_stream(failed.device).cuda_stream
        _bump(LAUNCHES)
        rc = lib.genasm_ladder_gate_launch(failed.data_ptr(), failed.numel(),
                                           out.data_ptr(), stream)
    _check(lib, "genasm_ladder_gate launch", rc)
    return out


class _Chain:
    """The nodes of one graph (the top graph or an IF node's body), each
    behind the one before; ``gates`` are its own gate nodes."""

    def __init__(self, lib, graph: ctypes.c_void_p, device: torch.device):
        self._lib, self._graph, self._device = lib, graph, device
        self._last = ctypes.c_void_p(None)
        self.nodes = self.gates = 0
        self.bodies = []

    def _add(self, what: str, fn, *args) -> None:
        node = ctypes.c_void_p()
        _check(self._lib, what, fn(self._graph, self._last, *args,
                                   ctypes.byref(node)))
        self._last = node
        self.nodes += 1

    def child(self, graph: torch.cuda.CUDAGraph) -> None:
        """A child-graph node of a capture (``keep_graph=True``); the memory
        its nodes address must live as long as the graph is launched."""
        self._add("cudaGraphAddChildGraphNode",
                  self._lib.genasm_graph_add_child,
                  ctypes.c_void_p(graph.raw_cuda_graph()))

    def branch(self, failed: list, flags: torch.Tensor) -> "_Chain":
        """Gates on each shard's `failed` (shard s's any into flags[s]), then
        an IF node on their condition (a handle of this chain's graph);
        returns its body's chain."""
        handle, node, body = (ctypes.c_ulonglong(), ctypes.c_void_p(),
                              ctypes.c_void_p())
        with torch.cuda.device(self._device):
            _check(self._lib, "cudaGraphConditionalHandleCreate",
                   self._lib.genasm_graph_conditional(self._graph,
                                                      ctypes.byref(handle)))
            for s, f in enumerate(failed):
                self._add("the gate's kernel node",
                          self._lib.genasm_graph_add_gate,
                          ctypes.c_void_p(f.data_ptr()), f.numel(),
                          ctypes.c_void_p(flags[s].data_ptr()), handle.value)
                self.gates += 1
            _check(self._lib, "the IF conditional node",
                   self._lib.genasm_graph_add_if(
                       self._graph, self._last, handle.value,
                       ctypes.byref(node), ctypes.byref(body)))
        self._last = node
        self.nodes += 1
        self.bodies.append(_Chain(self._lib, body, self._device))
        return self.bodies[-1]


def _destroy(lib, graph: ctypes.c_void_p, exe: list) -> None:
    if exe[0] is not None:
        lib.genasm_graph_exec_destroy(exe[0])
    lib.genasm_graph_destroy(graph)


class CondGraph:
    """A CUDA graph built node by node on `device`, one chain: child nodes
    of captured graphs (``child``), and branches (``branch``): a gate
    kernel a shard, then an IF node whose body, a chain of its own (which
    may branch again), runs where any lane of any of those shards is
    failed.  ``instantiate`` once, then ``launch`` on the current stream,
    as often as wanted; each launch counts the gate nodes of the top chain
    in ``LAUNCHES`` (a body's gates run only with the body: their caller
    counts them) and ``launches`` the graph's own launches.  The captures'
    memory pools must outlive it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lib = _library()
        self._graph = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(self._lib, "cudaGraphCreate",
                   self._lib.genasm_graph_create(ctypes.byref(self._graph)))
        self._exe = [None]
        self._finalize = weakref.finalize(self, _destroy, self._lib,
                                          self._graph, self._exe)
        self._top = _Chain(self._lib, self._graph, device)
        self.launches = 0

    @property
    def nodes(self) -> int:
        """Nodes of the top graph (a child graph or a body counts one)."""
        return self._top.nodes

    @property
    def gates(self) -> int:
        """Gate nodes of the top chain and of every body."""
        chains, n = [self._top], 0
        while chains:
            chain = chains.pop()
            n += chain.gates
            chains += chain.bodies
        return n

    def child(self, graph: torch.cuda.CUDAGraph) -> None:
        self._top.child(graph)

    def branch(self, failed: list, flags: torch.Tensor) -> _Chain:
        return self._top.branch(failed, flags)

    def instantiate(self) -> None:
        """Instantiate, and upload the work to the card on the current
        stream, waiting for it: the first launch then costs no more than
        the next."""
        exe = ctypes.c_void_p()
        stream = torch.cuda.current_stream(self.device)
        with torch.cuda.device(self.device):
            _check(self._lib, "cudaGraphInstantiate",
                   self._lib.genasm_graph_instantiate(self._graph,
                                                      ctypes.byref(exe)))
            self._exe[0] = exe
            _check(self._lib, "cudaGraphUpload",
                   self._lib.genasm_graph_upload(
                       exe, ctypes.c_void_p(stream.cuda_stream)))
        stream.synchronize()

    def launch(self) -> None:
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(self._lib, "cudaGraphLaunch",
               self._lib.genasm_graph_launch(self._exe[0],
                                             ctypes.c_void_p(stream)))
        self.launches += 1
        _bump(LAUNCHES, self._top.gates)
