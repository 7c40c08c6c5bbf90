"""Spans: named, nested time ranges of the port's work, recorded while a
``torch.profiler`` session records and never otherwise.

``span(name, **attrs)`` is a context manager. With the profiler off it
returns one shared null context: nothing is allocated, no CUDA call is
made and no profiler range opens. With it on, a span records

- its name and attributes (``rows``, ``d``, ``head``, ``kernel``);
- its parent: the innermost span open on its thread, or, on a thread with
  none open (autograd's device thread running a backward on CUDA
  tensors), the innermost span most recently opened on another thread,
  which is the backward phase that called ``backward()`` (units are
  opened from one thread at a time, as the trainer and the sampler do);
- its unit: a span with no parent is a root (a training step, a sampler
  call, an iteration of the train loop), and every span under it shares
  its id;
- its host start and end on ``time.time_ns()``, the clock that
  ``torch.profiler`` converts its events to;
- a range of the profiler's (``_RecordFunctionFast``, a fraction of
  ``record_function``'s cost): a host operator in its trace, linked to
  the kernels it launched;
- once CUDA is initialised, a pair of timing events on the current stream,
  which put it on the card's clock. They are read only by ``units()``,
  after a synchronize, so nothing waits on the card while spans record.
  Events come from a pool that ``clear()`` and dropped units refill, since
  making an event costs more than recording it.

Completed units go to a buffer of at most ``CAPACITY`` units; later ones
are dropped and counted (``dropped()``). ``units(name, n)`` returns the
first ``n`` completed root units of that name; ``clear()`` empties the
buffer.

The port's spans (PERF.md §3 names the metric each one feeds):
``step`` (``rows``) with ``step.g_forward``, ``step.d_passes``,
``step.d_backward``, ``step.d_adam`` (each with ``d``), ``step.g_loss``,
``step.g_backward``, ``step.g_adam`` (``train/step.py``); ``capsule.fwd``
and ``capsule.bwd`` (``head``, ``kernel``; ``ops/capsule_cuda.py``);
``sample.call`` (``rows``; ``train/sample.py``); ``train.iter`` with
``train.batch`` and ``train.is_stream`` (``train/trainer.py``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

CAPACITY = 256


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()
# the profiler's range; scope FUNCTION, where ``record_function``'s is USER
_Range = torch._C._profiler._RecordFunctionFast

_ids = itertools.count(1)
_stacks: Dict[int, list] = {}  # thread id -> its open spans, innermost last
_lock = threading.Lock()
_units: List['Span'] = []      # completed roots, oldest first
_dropped = 0
_free: list = []               # timing events no span holds


def _event():
    try:
        return _free.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _release(root: 'Span') -> None:
    """Give the timing events of ``root``'s unit back to the pool."""
    for s in root.members:
        if s.events is not None:
            _free.extend(e for e in s.events if e is not None)
            s.events = None


def span(name: str, **attrs):
    """A span named ``name`` while the profiler records, else ``NULL``."""
    if not torch.autograd._profiler_enabled():
        return NULL
    return Span(name, attrs)


def _adopter() -> Optional['Span']:
    """The innermost span most recently opened on any thread, or None."""
    best = None
    for stack in list(_stacks.values()):
        top = stack[-1:]
        if top and (best is None or top[0].id > best.id):
            best = top[0]
    return best


class Span:
    __slots__ = ('name', 'attrs', 'id', 'parent', 'unit', 'members',
                 'host_start_ns', 'host_end_ns', 'events', '_stream',
                 '_range', '_stack')

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> 'Span':
        stack = _stacks.setdefault(threading.get_ident(), [])
        parent = stack[-1] if stack else _adopter()
        self.id = next(_ids)
        self.parent = parent
        if parent is None:
            self.unit, self.members = self.id, []
        else:
            self.unit, self.members = parent.unit, parent.members
        self.members.append(self)
        stack.append(self)
        self._stack = stack
        self._range = _Range(self.name)
        self._range.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            # both events on the stream current at entry (one lookup: it
            # costs as much as recording an event)
            self._stream = torch.cuda.current_stream()
            start = _event()
            start.record(self._stream)
            self.events = [start, None]
        self.host_start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.host_end_ns = time.time_ns()
        if self.events is not None:
            end = _event()
            end.record(self._stream)
            self.events[1] = end
        self._range.__exit__(*exc)
        self._stack.pop()
        if self.parent is None:
            with _lock:
                kept = len(_units) < CAPACITY
                if kept:
                    _units.append(self)
                else:
                    _dropped += 1
            if not kept:
                _release(self)
        return False


def _as_dict(s: Span, anchor) -> dict:
    out = {'name': s.name, 'attrs': dict(s.attrs), 'id': s.id,
           'parent': None if s.parent is None else s.parent.id,
           'unit': s.unit, 'host_start_ns': s.host_start_ns,
           'host_end_ns': s.host_end_ns, 'device_ms': None,
           'device_start_ms': None, 'device_end_ms': None}
    if s.events is not None and s.events[1] is not None:
        start, end = s.events
        out['device_ms'] = start.elapsed_time(end)
        if anchor is not None:
            out['device_start_ms'] = anchor.elapsed_time(start)
            out['device_end_ms'] = anchor.elapsed_time(end)
    return out


def units(name: str, n: Optional[int] = None) -> List[dict]:
    """The first ``n`` (default all) completed root units named ``name``,
    oldest first: ``{'unit': id, 'spans': [...]}`` with the root first and
    the others in the order they opened. Each span is a dict of its name,
    attrs, id, parent (its parent's id; None for the root), unit, host
    start and end (ns), and on the card its device milliseconds
    (``device_ms``) and its start and end on the card's clock
    (``device_start_ms``, ``device_end_ms``, from the start of the
    buffer's first unit), else None."""
    with _lock:
        roots = [r for r in _units if r.name == name][:n]
        anchor = next((r.events[0] for r in _units if r.events), None)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return [{'unit': r.unit, 'spans': [_as_dict(s, anchor)
                                       for s in list(r.members)]}
            for r in roots]


def dropped() -> int:
    """Units dropped since the last ``clear()`` because the buffer was
    full."""
    return _dropped


def clear() -> None:
    """Empty the buffer; its timing events go back to the pool."""
    global _dropped
    with _lock:
        for root in _units:
            _release(root)
        _units.clear()
        _dropped = 0
