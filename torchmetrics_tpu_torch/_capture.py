"""CUDA graphs for the captured update path.

Counterpart of the part of ``torchmetrics_tpu/metric.py`` ``_global_jit``
(:133-345) that the fused collection update and the buffered flushes use:
where the JAX package compiles one jitted program per (owner, input
signature), the port captures one CUDA graph and replays it.

A :class:`CapturedStep` is one graph of a pure step
``step(states, inputs, trace) -> (new_states, appends)`` over:

- static slots: a copy of every state tensor the step reads, made at
  construction, and the input slots the caller passes (the fused update's
  copies of each input, the buffered ring's ``(K, ...)`` rows), all at
  addresses the graph bakes in;
- a warm-up on a side stream before capture, under
  ``torch.cuda.set_sync_debug_mode("error")``: it builds the kernel library
  at first use and runs the kernel's one-time attribute calls outside the
  capture, and a body that reads a value on the host fails there, by name;
- the graph, captured into a private memory pool. It reads the slots, runs
  the step and copies each new state back into its slot; the appends (cat
  increments) are its static outputs, and so is a new state of another
  shape than its slot (RASE's scalar defaults, which its first update
  broadcasts into maps: the next update's states have other shapes, hence
  another graph); a new state of another dtype raises.

A replay writes the state slots in place, so the owner installs the slots
as its states after a replay, each marked ``_tm_graph_slot``, and the metric
never hands a slot out: every state observation installs a clone first
(copy-on-expose, ``Metric._release_graph_states``). A replay copies a state
into its slot whenever the installed state is not that slot. Graphs belong
to one instance, since they bake in their slots' addresses and those of the
metric's constant tensors: clones share nothing (the JAX cache shares
executables between equal configurations).

A member declared capturable whose step cannot be captured raises
:class:`CaptureError`, naming the member and the op: nothing falls back to
the eager loop.

What a capture reports goes through one seam, :func:`report_capture`,
which :class:`CapturedStep` calls after it captures: the ``graph.*``
counters of the registry (a capture; a recapture when its owner already
held a graph under another key, the counterpart of a JAX retrace; each
replay), the compile observers of ``debug.strict_mode`` and, when armed,
the executable ledger (:mod:`~torchmetrics_tpu_torch.observability.ledger`).
"""
import contextlib
import gc
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from .observability import ledger as _ledger
from .observability.registry import REGISTRY as _REGISTRY
from .ops import bincount

Tensor = torch.Tensor
StepStates = Dict[str, Dict[str, Tensor]]
Step = Callable[[StepStates, List[Any], List[Optional[str]]], Tuple[StepStates, Dict[str, Any]]]

SLOT_MARK = "_tm_graph_slot"
_PKG_DIR = Path(__file__).resolve().parent
# registry-backed: captured CUDA graphs, recaptures (captures by an owner that
# already held a graph under another key) and replays in this process
_GRAPH_STATS = _REGISTRY.group(
    "graph",
    {"captures": 0, "recaptures": 0, "replays": 0},
    help="captured CUDA graphs",
)
_REPLAYS = _REGISTRY.counter("graph.replays")  # the group's counter, bumped once per replay
# observers called as cb(key, new_captures, recaptures) after every capture;
# used by debug.strict_mode() to fail fast
_COMPILE_OBSERVERS: List[Callable[[Any, int, int], None]] = []
# Python numbers are staged as 0-d tensors in the JAX package's dtypes
_SCALAR_DTYPES = {bool: torch.bool, int: torch.int32, float: torch.float32}


def graph_stats() -> Dict[str, int]:
    """Graphs captured, recaptured and replayed in this process: a view of
    the registry's ``graph.*`` counters."""
    return dict(_GRAPH_STATS)


def reset_graph_stats() -> None:
    _GRAPH_STATS.reset()


def report_capture(key: Any, graph: Any, recapture: bool) -> None:
    """What one capture reports: the ``graph.*`` counters, the ledger when
    armed, then the compile observers (which may raise). ``graph`` is the
    :class:`CapturedStep` just captured, ``key`` its :func:`graph_key`."""
    _GRAPH_STATS["captures"] += 1
    if recapture:
        _GRAPH_STATS["recaptures"] += 1
    if _ledger.ENABLED:
        _ledger.record_capture(key, graph, 1, int(recapture))
    for cb in list(_COMPILE_OBSERVERS):
        cb(key, 1, int(recapture))


class CaptureError(RuntimeError):
    """A member declared capturable (``jittable`` and ``jit=True``) could not
    be captured into a CUDA graph. The message names the member and the op;
    construct the metric with ``jit=False`` to keep it eager."""


def is_graph_slot(value: Any) -> bool:
    return isinstance(value, Tensor) and getattr(value, SLOT_MARK, False)


def is_scalar(leaf: Any) -> bool:
    """A Python number (not a numpy scalar, which the metrics refuse)."""
    return type(leaf) in _SCALAR_DTYPES


def capturable_leaf(leaf: Any) -> bool:
    """An input leaf a graph can take: a tensor, a Python number (staged as a
    0-d tensor) or ``None`` (kept in the signature). The counterpart of JAX
    ``_jit_safe_inputs`` (``metric.py:112``)."""
    return leaf is None or isinstance(leaf, Tensor) or is_scalar(leaf)


def scalar_tensor(value: Any, device: torch.device, shape: Tuple[int, ...] = ()) -> Tensor:
    """A Python number as a tensor in the JAX package's dtypes, filled on
    the device: no host-to-device copy."""
    return torch.full(shape, value, dtype=_SCALAR_DTYPES[type(value)], device=device)


def leaf_signature(leaf: Any) -> Any:
    if isinstance(leaf, Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device)
    if leaf is None:
        return None
    return ("scalar", type(leaf).__name__)


def flatten_step(args: tuple, kwargs: dict) -> Tuple[List[Any], Any]:
    """One step's input leaves and their structure."""
    return tree_flatten((args, kwargs))


def signature_of(leaves: List[Any], spec: Any) -> tuple:
    """Hashable (structure, shapes, dtypes, devices) key of one step's
    leaves: a Python number is keyed by its type, not its value, as JAX keys
    weak-typed scalars. Steps of one signature share a graph."""
    return (spec, tuple(leaf_signature(leaf) for leaf in leaves))


def graph_key(op: Any, signature: Any, reps: Any, states: StepStates) -> tuple:
    """What a graph bakes in beside its input slots, as a cache key: the op
    (``"update"``, ``"mc_fused_update"``, ``("stream_flush", K)``), the
    input signature, each member's class, ``_apply_epoch`` (a device or
    dtype move rebinds the constant tensors an update body reads, such as a
    threshold grid), state shapes and dtypes, and what the member adds
    (``Metric._graph_key_extra``: a ``TenantStack``'s slot count). The
    ledger and ``strict_mode`` name the metric and op from it
    (``observability.ledger.describe_key``)."""
    return (op, signature, tuple((name, type(rep), rep._apply_epoch,
                                  tuple((k, v.shape, v.dtype) for k, v in states[name].items()),
                                  rep._graph_key_extra())
                                 for name, rep in reps))


def new_input_slots(leaves: List[Any], device: torch.device, rows: Optional[int] = None) -> List[Any]:
    """Static slots for a step's input leaves: one tensor of each tensor
    leaf's shape and dtype (``(rows, *shape)`` for a ring of ``rows``
    steps), a 0-d (or ``(rows,)``) tensor for each number, ``None`` as it is."""
    lead = () if rows is None else (rows,)
    out: List[Any] = []
    for leaf in leaves:
        if isinstance(leaf, Tensor):
            out.append(torch.empty(lead + tuple(leaf.shape), dtype=leaf.dtype, device=device))
        elif leaf is None:
            out.append(None)
        else:
            out.append(scalar_tensor(leaf, device, lead))
    return out


def write_inputs(slots: List[Any], leaves: List[Any], row: Optional[int] = None) -> None:
    """Copy a step's leaves into their slots (row ``row`` of a ring): one
    device-to-device copy per tensor, one fill per number."""
    with torch.no_grad():
        for slot, leaf in zip(slots, leaves):
            if slot is None:
                continue
            target = slot if row is None else slot[row]
            if isinstance(leaf, Tensor):
                target.copy_(leaf)
            else:
                target.fill_(leaf)


def _failing_op(err: BaseException) -> str:
    """``file:line `source``` of the innermost frame along the exception
    chain that is neither torch's, the standard library's nor this
    module's: the update body's line that failed."""
    skip = (Path(torch.__file__).resolve().parent, Path(contextlib.__file__).resolve().parent)
    found = None
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        for frame in traceback.extract_tb(err.__traceback__):
            path = Path(frame.filename).resolve()
            if path.name != "_capture.py" and not any(d in path.parents for d in skip):
                found = frame
        if found is not None:
            break
        err = err.__cause__ or err.__context__
    if found is None:
        return "an op inside torch"
    path = Path(found.filename).resolve()
    where = path.relative_to(_PKG_DIR.parent) if _PKG_DIR.parent in path.parents else path.name
    return f"{where}:{found.lineno} `{(found.line or '').strip()}`"


@contextmanager
def _host_reads_raise():
    """A synchronizing CUDA call inside the block raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _new_slot(value: Tensor) -> Tensor:
    slot = value.detach().clone()
    setattr(slot, SLOT_MARK, True)
    return slot


def write_back(state_slots: StepStates, new_states: StepStates, label: str) -> StepStates:
    """Copy each new state into its slot (inside a capture: the graph's last
    nodes) and return the new states kept as outputs instead: those of
    another shape than their slot (RASE's scalar defaults, broadcast into
    maps at the first update), marked as slots, since a replay rewrites
    them. A new state of another dtype raises. A new state that is a view
    of some slot is cloned before any slot is written, so no copy reads a
    slot another copy already changed."""
    slot_storage = {s.untyped_storage().data_ptr() for st in state_slots.values() for s in st.values()}
    writes = []
    outputs: StepStates = {}
    for owner, named in new_states.items():
        for name, value in named.items():
            slot = state_slots[owner][name]
            if value is slot:
                continue
            if value.dtype != slot.dtype:
                raise CaptureError(
                    f"{label}: member {owner!r} turns state {name!r} from {slot.dtype} into {value.dtype}; a "
                    "captured update keeps each state's dtype. Construct it with jit=False to keep it eager.")
            if value.untyped_storage().data_ptr() in slot_storage:
                value = value.clone()
            if value.shape != slot.shape:
                setattr(value, SLOT_MARK, True)
                outputs.setdefault(owner, {})[name] = value
                continue
            writes.append((slot, value))
    for slot, value in writes:
        slot.copy_(value)
    return outputs


def step_results(state_slots: StepStates, outputs: StepStates) -> StepStates:
    """A step's new states: its slots, with the reshaped states of
    :func:`write_back` in their place."""
    return {o: {**slots, **outputs.get(o, {})} for o, slots in state_slots.items()}


class CapturedStep:
    """One CUDA graph of ``step`` for one owner and one input signature.

    ``states`` ({owner: {state: tensor}}) gives the state slots' shapes,
    dtypes and first values; ``input_slots`` are the caller's static input
    tensors, which it writes before each :meth:`run`. ``label`` names the
    owner in errors. ``step`` writes the name of the member it is running
    into ``trace[0]``, so a failure names it. ``key`` is the owner's
    :func:`graph_key` for it and ``recapture`` whether the owner already
    holds a graph under another key; both go to :func:`report_capture`.
    With the ledger armed the step runs once more before its warm-up, under
    ``FlopCounterMode`` (``flops``).
    """

    def __init__(self, step: Step, states: StepStates, input_slots: List[Any], device: torch.device,
                 label: str, key: Any = None, recapture: bool = False) -> None:
        self.device = device
        self.label = label
        self.input_slots = input_slots
        self.replays = 0
        self.flops: Optional[float] = None
        trace: List[Optional[str]] = [None]
        with torch.cuda.device(device), torch.no_grad():
            self.state_slots = {o: {k: _new_slot(v) for k, v in st.items()} for o, st in states.items()}
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            try:
                with torch.cuda.stream(side), _host_reads_raise():
                    if _ledger.ENABLED:
                        # the ledger's count, a run of its own: the warm-up below,
                        # which runs the one-time setup the capture relies on,
                        # stays as it is without the ledger
                        _, self.flops = _ledger.step_flops(lambda: step(self.state_slots, input_slots, trace))
                    step(self.state_slots, input_slots, trace)
            except Exception as err:
                raise self._error(trace, "reads a value on the host or fails eagerly", err) from err
            current.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a collection there can
            # finalise an old graph held by a reference cycle, and that graph's
            # reset invalidates the capture (torch.cuda.graph collects before a
            # capture only under torch.compiler.config.force_cudagraph_gc)
            gc_was_enabled = gc.isenabled()
            gc.disable()
            try:
                with bincount.recording_launches() as record:
                    with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                        new_states, appends = step(self.state_slots, input_slots, trace)
                        outputs = write_back(self.state_slots, new_states, label)
            except CaptureError:
                raise
            except Exception as err:
                raise self._error(trace, "cannot be captured", err) from err
            finally:
                if gc_was_enabled:
                    gc.enable()
        self.launches = record
        self.appends = appends
        self.results = step_results(self.state_slots, outputs)
        for owner, named in appends.items():
            for name, incs in named.items():
                for inc in incs:
                    if not isinstance(inc, Tensor):
                        raise CaptureError(f"{label}: member {owner!r} appends a {type(inc).__name__} to "
                                           f"{name!r}; only tensor increments can leave a CUDA graph")
        report_capture(key, self, recapture)

    def _error(self, trace: List[Optional[str]], what: str, err: BaseException) -> CaptureError:
        return CaptureError(f"{self.label}: the update of member {trace[0]!r} {what}, at {_failing_op(err)}: "
                            f"{type(err).__name__}: {err}. Construct it with jit=False to keep it eager.")

    def run(self, states: StepStates) -> Tuple[StepStates, Dict[str, Any]]:
        """Copy each state that is not its slot into the slot, replay, and
        return the new states (the slots and the reshaped outputs) and the
        appends. The caller has written the input slots."""
        with torch.cuda.device(self.device), torch.no_grad():
            for owner, named in states.items():
                slots = self.state_slots[owner]
                for name, value in named.items():
                    slot = slots[name]
                    if value is not slot:
                        slot.copy_(value)
            self.graph.replay()
        bincount.count_replayed_launches(self.launches)
        self.replays += 1
        _REPLAYS.inc()
        return self.results, self.appends
