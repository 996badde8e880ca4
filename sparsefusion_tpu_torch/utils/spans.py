"""The port's span recorder: named, nested spans of host time and, on a
CUDA device, of device time, inside replayed CUDA graphs too.

Host side.  ``span(name, **counts)`` is a context manager.  A span
records its name, its host start and end on the clock of
``torch.profiler``'s host events (``time.time_ns``: Unix nanoseconds),
its parent (the span open around it, which gives self time), the unit of
work it belongs to (``unit(kind, index)``: a distillation iteration, a
train step's call; a span recorded between two units belongs to the
next, as the batch a caller builds for a train step does) and the
counters added while it was the innermost open span (:func:`count`).  Finished spans are kept in a bounded ring of
:data:`SPANS` and handed out by :func:`snapshot` and :func:`dump`.

* Units and the spans inside them are recorded while a
  ``torch.profiler`` session records or after :func:`enable`; whether a
  unit records is decided when it opens, so with recording off a span
  costs one flag check on the host.  Spans outside any unit check the
  same two switches when they open.
* Set-up spans (:func:`setup_span`: ``phase_a``, ``capture/<key>``,
  ``warmup/<key>``, ``kernels/load``) are always recorded, host time
  only; a run has a few dozen.
* A recorded span that is not a unit is also a ``record_function``
  range while the profiler records, so an idle gap of the device in a
  profile sits under a span of the program's own name.  Units are not:
  a range around a whole iteration would take the name of every gap in
  it.  Spans that the autograd engine's thread ends
  (:func:`backward_span`, :func:`switch`) are not ranges either.

Device side.  On a CUDA device (:func:`use_device`) each edge of a
recorded span enqueues ``span_stamp_kernel`` (``csrc/span_stamp.cu``):
one thread writes (slot, tag, ``%globaltimer``) into a ring of
:data:`SLOTS` stamps at a cursor it advances on the device.  Inside a
CUDA graph's capture (:func:`capture`, which ``utils/graphs.py``'s
``GraphRunner`` opens) the spans are not recorded but kept as the
graph's template (names, nesting, counters, stamp offsets), and their
stamps are captured whatever the switches say: a graph is captured in
set-up, before any profiler starts, and cannot gain stamps later.  Each
replay (:func:`replay`) advances the host's mirror of the cursor by the
template's stamps and, while recording, records the host span
``graph/<key>`` with the template's spans under it, each tied to its
replay's stamps.  Eager runs (a key's first run, every run on the CPU)
go through the same spans; on the CPU the device times are None.

The host reads the stamps when asked (:func:`snapshot`), and where the
program synchronises already (:func:`sync_point`, at the loss reads)
only to report a line (:func:`enable`'s ``report``) or before the
device's ring would wrap over unread stamps; a loss read otherwise costs
what it cost without the recorder.  A snapshot, and each graph's
capture in set-up (:func:`calibrate`), calibrates: the host's clock
before and after a synchronise around one stamp, a few times; the
narrowest such pair gives the two clocks' offset at that point, and a
stamp converts to the host clock by the offset interpolated between the
calibrations around it; the widest of the pairs used is the
conversion's error (:func:`clock`).
"""
from __future__ import annotations

import bisect
import collections
import json
import time
from typing import Callable, Dict, List, Optional

import torch

# finished spans kept on the host; stamp slots on the device (3 int64
# each: 1.5 MiB)
SPANS = 1 << 16
SLOTS = 1 << 16
_CALIBRATION_TAG = -1

_now = time.time_ns          # torch.profiler's host events' clock
_profiling = torch._C._autograd._profiler_enabled
# a profiler range with the least overhead between its clock reading and
# the span's (a few us, against tens for ``record_function``)
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.autograd.profiler.record_function)


class Span:
    """One finished span.  ``kind``: "unit", "setup" or "span"; ``unit``:
    the index of the unit it belongs to; ``t0``/``t1``: host ns (None
    for the spans of a graph's replay, which run no host code);
    ``s0``/``s1``: its stamps' slots (in the ring's order of execution);
    ``g0``/``g1``: their device clock;
    ``profiled``: a profiler was recording when it opened."""

    __slots__ = ("id", "name", "kind", "parent", "unit", "t0", "t1", "s0",
                 "s1", "g0", "g1", "counts", "profiled", "_range")

    def __init__(self, sid, name, kind, parent, unit, profiled):
        self.id, self.name, self.kind = sid, name, kind
        self.parent, self.unit, self.profiled = parent, unit, profiled
        self.t0 = self.t1 = self.s0 = self.s1 = self.g0 = self.g1 = None
        self.counts = None
        self._range = None

    def add(self, name: str, n) -> None:
        if self.counts is None:
            self.counts = {}
        self.counts[name] = self.counts.get(name, 0) + n

    def as_dict(self, host: Optional[Callable[[int], int]]) -> dict:
        dev = host is not None and self.g0 is not None \
            and self.g1 is not None
        return {"id": self.id, "name": self.name, "kind": self.kind,
                "parent": self.parent, "unit": self.unit,
                "t0": self.t0, "t1": self.t1,
                "d0": host(self.g0) if dev else None,
                "d1": host(self.g1) if dev else None,
                "counts": dict(self.counts or {}),
                "profiled": self.profiled, "slots": [self.s0, self.s1]}


class Template:
    """A captured graph's spans: position 0 the graph itself
    (``graph/<key>``), each entry [name, parent position, counts, first
    stamp's offset, second's]; ``stamps`` the stamps a replay writes."""

    def __init__(self, name: str):
        self.name = name
        self.spans: List[list] = []
        self.stamps = 0


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Recorder:
    """The process's recorder (one, :data:`_R`): the switches, the stack
    of open spans, the ring of finished ones, the template of a capture
    in progress, and the device's ring of stamps with the host's mirror
    of its cursor."""

    def __init__(self):
        self.enabled = False
        self.reporter: Optional[Callable[[str], None]] = None
        self.on = False               # the open unit records
        self.unit: Optional[int] = None
        self.unit_open = False
        self.stack: List[Span] = []   # open recorded host spans
        self.spans = collections.deque(maxlen=SPANS)
        self.pending: List[Span] = []  # spans with unread stamps
        self.pending_from = 0         # the first one's slot
        self.unit_end = 0             # the id after the last unit's
        self.next_id = 0
        self.template: Optional[Template] = None
        self.tstack: List[int] = []
        self.names: Dict[str, int] = {}
        self.reported = self.setup_reported = 0
        # the device ring
        self.ring = None
        self.stamping = False
        self.cursor = 0               # the host's mirror of the device's
        self._cursor_dev = None
        self._launch = None
        # each calibrating read's narrowest pair: (device ns, offset ns,
        # width ns), in the device clock's order
        self.points = collections.deque(maxlen=1024)

    # ---- switches -----------------------------------------------------

    def use_device(self, device) -> None:
        device = torch.device(device)
        self.stamping = device.type == "cuda"
        if self.stamping and self.ring is None:
            from sparsefusion_tpu_torch.kernels._build import load_library

            self._launch = load_library().sf_span_stamp
            self.ring = torch.zeros((SLOTS, 3), dtype=torch.int64,
                                    device=device)
            self._cursor_dev = torch.zeros((1,), dtype=torch.int64,
                                           device=device)

    # ---- stamps -------------------------------------------------------

    def _tag(self, name: str, edge: int) -> int:
        nid = self.names.get(name)
        if nid is None:
            nid = self.names[name] = len(self.names)
        return 2 * nid + edge

    def _stamp(self, tag: int) -> int:
        """Enqueue a stamp on the current stream; its slot (in a capture,
        its offset in the replay)."""
        stream = torch.cuda.current_stream(self.ring.device).cuda_stream
        err = self._launch(self.ring.data_ptr(), self._cursor_dev.data_ptr(),
                           SLOTS, tag, stream)
        if err != 0:
            raise RuntimeError(f"span stamp launch failed: CUDA error {err}")
        tpl = self.template
        if tpl is not None:
            tpl.stamps += 1
            return tpl.stamps - 1
        self.cursor += 1
        return self.cursor - 1

    # ---- opening and closing ------------------------------------------

    def open(self, name: str, kind: str, counts, stamp: bool,
             ranged: bool) -> Span:
        parent = self.stack[-1].id if self.stack else None
        profiled = _profiling()
        sp = Span(self.next_id, name, kind, parent, self.unit, profiled)
        self.next_id += 1
        if counts:
            sp.counts = dict(counts)
        if stamp and self.stamping:
            sp.s0 = self._stamp(self._tag(name, 0))
        if ranged and profiled:
            sp._range = _Range(name)
            sp._range.__enter__()
        self.stack.append(sp)
        sp.t0 = _now()
        return sp

    def close(self, sp: Span) -> None:
        sp.t1 = _now()
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        if sp.s0 is not None:
            sp.s1 = self._stamp(self._tag(sp.name, 1))
            self.pend(sp)
        if self.stack and self.stack[-1] is sp:
            self.stack.pop()
        else:
            self.stack.remove(sp)
        self.spans.append(sp)

    def topen(self, name: str, counts) -> int:
        """Open a span of the template being captured: its position."""
        tpl = self.template
        parent = self.tstack[-1] if self.tstack else -1
        entry = [name, parent, dict(counts) if counts else None,
                 self._stamp(self._tag(name, 0)) if self.ring is not None
                 else None, None]
        tpl.spans.append(entry)
        self.tstack.append(len(tpl.spans) - 1)
        return self.tstack[-1]

    def tclose(self, pos: int) -> None:
        entry = self.template.spans[pos]
        if entry[3] is not None:
            entry[4] = self._stamp(self._tag(entry[0], 1))
        self.tstack.remove(pos)

    # ---- reading the stamps --------------------------------------------

    def pend(self, sp: Span) -> None:
        """``sp`` waits for its stamps to be read."""
        if not self.pending:
            self.pending_from = sp.s0
        self.pending.append(sp)

    def drain(self, calibrations: int = 0, spans: bool = True) -> None:
        """After ``calibrations`` calibration stamps (a synchronise each),
        read those and, with ``spans``, the stamps of the finished spans
        that wait for them: only their rows of the ring."""
        if self.ring is None or not ((spans and self.pending)
                                     or calibrations):
            if spans:
                self.pending.clear()
            return
        device = self.ring.device
        torch.cuda.synchronize(device)
        pairs = []
        for _ in range(calibrations):
            t0 = _now()
            slot = self._stamp(_CALIBRATION_TAG)
            torch.cuda.synchronize(device)
            pairs.append((slot, t0, _now()))
        oldest = self.cursor - SLOTS
        want = [slot for slot, _, _ in pairs]
        if spans:
            want += [x for sp in self.pending for x in (sp.s0, sp.s1)
                     if x is not None and x >= oldest]
        idx = torch.tensor([x % SLOTS for x in want], device=device)
        rows = dict(zip(want, self.ring.index_select(0, idx).tolist()))

        def at(slot):
            row = rows.get(slot)
            return row[2] if row is not None and row[0] == slot else None

        best = None
        for slot, t0, t1 in pairs:
            g = at(slot)
            if g is not None and (best is None or t1 - t0 < best[2]):
                best = (g, g - (t0 + t1) // 2, t1 - t0)
        if best is not None:
            self.points.append(best)
        if spans:
            for sp in self.pending:
                sp.g0, sp.g1 = at(sp.s0), at(sp.s1)
            self.pending.clear()

    def host_clock(self) -> Optional[Callable[[int], int]]:
        """Device ns -> host ns: the offset interpolated between the
        calibrations on either side (the nearest one's outside them),
        which follows a drift of one clock against the other."""
        if not self.points:
            return None
        gs = [p[0] for p in self.points]
        offs = [p[1] for p in self.points]

        def host(g: int) -> int:
            k = bisect.bisect_left(gs, g)
            if k == 0 or k == len(gs):
                return g - offs[min(k, len(gs) - 1)]
            span = gs[k] - gs[k - 1]
            return g - offs[k - 1] - (offs[k] - offs[k - 1]) * (
                g - gs[k - 1]) // span

        return host


_R = Recorder()


class _Open:
    """A recorded span's ``with``: it ends the span at its level of the
    stack, which :func:`switch` may have handed to a successor."""

    __slots__ = ("kind", "name", "counts", "ranged", "depth", "template")

    def __init__(self, name, kind="span", counts=None, ranged=True):
        self.name, self.kind, self.counts = name, kind, counts
        self.ranged = ranged

    def __enter__(self):
        r = _R
        self.template = r.template is not None and self.kind == "span"
        if self.template:
            self.depth = len(r.tstack)
            r.topen(self.name, self.counts)
            return None
        self.depth = len(r.stack)
        return r.open(self.name, self.kind, self.counts,
                      stamp=self.kind != "setup", ranged=self.ranged)

    def __exit__(self, *exc):
        r = _R
        if self.template:
            if r.template is not None and len(r.tstack) > self.depth:
                r.tclose(r.tstack[self.depth])
        elif len(r.stack) > self.depth:
            r.close(r.stack[self.depth])
        return False


def span(name: str, **counts):
    """A span named ``name`` with counters ``counts`` to start from; a
    no-op unless recording or inside a capture."""
    r = _R
    if r.on or r.template is not None or (
            not r.unit_open and (r.enabled or _profiling())):
        return _Open(name, "span", counts)
    return _NULL


def backward_span(name: str):
    """A span around a backward call: the autograd engine's thread may
    end it (:func:`switch`), so it is never a profiler range."""
    r = _R
    if r.on or r.template is not None or (
            not r.unit_open and (r.enabled or _profiling())):
        return _Open(name, "span", None, ranged=False)
    return _NULL


def switch(name: str, expect: str) -> None:
    """End the innermost open span, if it is a ``backward_span`` named
    ``expect``, and open ``name`` in its place (a backward's later part,
    split off by a gradient hook); the ``with`` of the first ends it."""
    r = _R
    if r.template is not None:
        if r.tstack and r.template.spans[r.tstack[-1]][0] == expect:
            r.tclose(r.tstack[-1])
            r.topen(name, None)
        return
    if r.stack and r.stack[-1].name == expect and r.stack[-1].kind == "span":
        r.close(r.stack[-1])
        r.open(name, "span", None, stamp=True, ranged=False)


def setup_span(name: str):
    """A one-off set-up span: always recorded, host time only; its
    ``with`` gives the :class:`Span`."""
    return _Open(name, "setup")


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    r = _R
    if r.template is not None:
        if r.tstack:
            entry = r.template.spans[r.tstack[-1]]
            if entry[2] is None:
                entry[2] = {}
            entry[2][name] = entry[2].get(name, 0) + n
    elif r.stack:
        r.stack[-1].add(name, n)


class _Unit:
    __slots__ = ("kind", "index", "sp")

    def __init__(self, kind, index):
        self.kind, self.index, self.sp = kind, index, None

    def __enter__(self):
        r = _R
        r.on = r.enabled or _profiling()
        r.unit, r.unit_open = self.index, True
        if r.on:
            # the spans recorded since the last unit are this one's
            for s in reversed(r.spans):
                if s.id < r.unit_end:
                    break
                if s.unit is None and s.kind == "span":
                    s.unit = self.index
            self.sp = r.open(self.kind, "unit", None, stamp=True,
                             ranged=False)
        return self

    def __exit__(self, *exc):
        r = _R
        if self.sp is not None:
            r.close(self.sp)
        r.on, r.unit, r.unit_open = False, None, False
        r.unit_end = r.next_id
        return False


def unit(kind: str, index: int):
    """The unit of work ``index`` of ``kind`` (``distill/iteration``,
    ``train/step``): the spans opened inside it carry its index, and it
    records only while a profiler records or after :func:`enable`.  The
    spans recorded after the last unit ended are this unit's too."""
    return _Unit(kind, int(index))


class _Capture:
    def __init__(self, name):
        self.tpl = Template(name)

    def __enter__(self):
        r = _R
        if r.template is not None:
            raise RuntimeError("a capture inside a capture")
        r.template, r.tstack = self.tpl, []
        r.topen(self.tpl.name, None)
        return self.tpl

    def __exit__(self, *exc):
        r = _R
        try:
            if exc[0] is None:
                r.tclose(0)
        finally:
            r.template, r.tstack = None, []
        return False


def capture(name: str):
    """Inside a CUDA graph's capture: the spans opened in it, and the
    graph's own span ``name``, become the template it returns."""
    return _Capture(name)


class _Replay:
    __slots__ = ("tpl", "base", "sp")

    def __init__(self, tpl, base):
        self.tpl, self.base, self.sp = tpl, base, None

    def __enter__(self):
        r, tpl = _R, self.tpl
        sp = self.sp = r.open(tpl.name, "span", tpl.spans[0][2],
                              stamp=False, ranged=True)
        if tpl.spans[0][3] is not None:
            sp.s0 = self.base + tpl.spans[0][3]
            sp.s1 = self.base + tpl.spans[0][4]
        return sp

    def __exit__(self, *exc):
        r, tpl, sp = _R, self.tpl, self.sp
        ids = [sp.id]
        for name, parent, counts, o0, o1 in tpl.spans[1:]:
            child = Span(r.next_id, name, "span", ids[parent], sp.unit,
                         sp.profiled)
            r.next_id += 1
            ids.append(child.id)
            child.counts = counts
            if o0 is not None:
                child.s0, child.s1 = self.base + o0, self.base + o1
                r.pend(child)
            r.spans.append(child)
        sp.t1 = _now()
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        if sp.s0 is not None:
            r.pend(sp)
        r.stack.remove(sp)
        r.spans.append(sp)
        return False


def replay(tpl: Template):
    """Around a graph's replay: advances the stamps' cursor by the
    template's and, while recording, records ``graph/<key>`` and the
    template's spans under it."""
    r = _R
    base = r.cursor
    r.cursor += tpl.stamps
    if r.on or (not r.unit_open and (r.enabled or _profiling())):
        return _Replay(tpl, base)
    return _NULL


def active() -> bool:
    """Whether a span opened now records or is captured (for work that
    only a span needs, such as a gradient hook)."""
    r = _R
    return r.on or r.template is not None or (
        not r.unit_open and (r.enabled or _profiling()))


def sync_point() -> None:
    """Where the program has just synchronised (a loss read): with a
    reporter, read the stamps and report the units and set-up spans
    finished since the last report; else read them only if the ring
    would soon wrap over the oldest unread stamp."""
    r = _R
    if r.reporter is not None:
        r.drain()
        units = [s for s in r.spans if s.kind == "unit"
                 and s.id >= r.reported]
        setup = [s for s in r.spans if s.kind == "setup"
                 and s.id >= r.setup_reported]
        if setup:
            r.setup_reported = max(s.id for s in setup) + 1
            r.reporter(setup_line(setup))
        if units:
            line = report_line(r, units, r.reported)
            r.reported = max(u.id for u in units) + 1
            r.reporter(line)
    elif r.pending and r.cursor - r.pending_from > SLOTS // 2:
        r.drain()


def _host_ns(sp: Span) -> int:
    return sp.t1 - sp.t0 if sp.t0 is not None and sp.t1 is not None else 0


def report_line(r: Recorder, units: List[Span], since: int) -> str:
    """One line: per unit, the host's own ms (the unit's and the spans
    before it, less its graph launches, which wait for room in the
    device's queue, and its loss reads), those two, the device ms, each
    layer's device ms, and the UNet's evaluations and their batch."""
    ids = {u.unit for u in units}
    n = len(units)
    mine = [s for s in r.spans if s.id >= since and s.unit in ids]
    host = sum(_host_ns(s) for s in mine if s.parent is None) / n * 1e-6
    launch = sum(_host_ns(s) for s in mine
                 if s.name.startswith("graph/")) / n * 1e-6
    waits = sum(_host_ns(s) for s in mine
                if s.name == "loss_read") / n * 1e-6
    dev: Dict[str, float] = {}
    for s in mine:
        if s.kind == "span" and s.g0 is not None and s.g1 is not None \
                and not s.name.startswith("graph/"):
            dev[s.name] = dev.get(s.name, 0.0) + (s.g1 - s.g0) * 1e-6
    unit_dev = [u.g1 - u.g0 for u in units
                if u.g0 is not None and u.g1 is not None]
    parts = [f"spans: {n} x {units[0].name}",
             f"host {host - launch - waits:.2f} ms/unit (+{launch:.2f} in "
             f"graph launches, +{waits:.2f} loss read)"]
    if unit_dev:
        parts.append(f"device {sum(unit_dev) / len(unit_dev) * 1e-6:.2f} "
                     "ms/unit")
        parts += [f"{k} {v / n:.2f}" for k, v in
                  sorted(dev.items(), key=lambda kv: -kv[1])]
    unets = [s.counts.get("unet_batch", 0) for s in mine
             if s.name == "unet" and s.counts]
    if unets:
        parts.append(f"unet {len(unets) / n:.2f}/unit at batch "
                     f"{sum(unets) / len(unets):.3g}")
    return "; ".join(parts)


def setup_line(setup: List[Span]) -> str:
    """One line: the set-up spans' host seconds, those of one kind
    (``warmup/<key>``, ``capture/<key>``) summed with their number."""
    total: Dict[str, list] = {}
    for s in setup:
        kind = s.name.split("/")[0]
        got = total.setdefault(kind, [0, 0.0])
        got[0] += 1
        got[1] += _host_ns(s) * 1e-9
    return "spans set-up: " + "; ".join(
        f"{k} {v:.3f} s" if c == 1 else f"{k} {c} x {v:.3f} s"
        for k, (c, v) in total.items())


# ---- the module's interface --------------------------------------------

def enable(report: Optional[Callable[[str], None]] = None) -> None:
    """Record every unit (not only under a profiler); with ``report``,
    hand it a line of per-unit host and device ms at each loss read."""
    _R.enabled = True
    _R.reporter = report
    _R.reported = _R.setup_reported = _R.next_id


def disable() -> None:
    _R.enabled = False
    _R.reporter = None


def use_device(device) -> None:
    """Stamp the device time of recorded spans on ``device`` (a CUDA
    device; any other turns the stamps of eager spans off).  Makes the
    ring, and loads the kernels' library, at the first CUDA device."""
    _R.use_device(device)


def mark() -> int:
    """The id the next span will take: :func:`snapshot`'s ``since``."""
    return _R.next_id


def snapshot(since: int = 0) -> List[dict]:
    """The recorded spans from id ``since`` on, as dicts, with device
    times on the host clock in ns (None without a calibration or on the
    CPU).  Reads the stamps still waiting, after eight calibrations (a
    synchronise each)."""
    r = _R
    r.drain(calibrations=8)
    host = r.host_clock()
    return sorted((s.as_dict(host) for s in r.spans if s.id >= since),
                  key=lambda d: d["id"])


def calibrate() -> None:
    """Where the program synchronises in set-up (after a graph's
    capture): calibrate the device clock, so that a later window's
    stamps convert between this calibration and the snapshot's."""
    _R.drain(calibrations=2, spans=False)


def clock() -> dict:
    """The device clock's conversion: its error (the widest of the
    calibrations' narrowest pairs, ns) and each calibration's (device
    ns, offset ns, width ns)."""
    pts = [list(p) for p in _R.points]
    return {"error_ns": max(p[2] for p in pts) if pts else None,
            "points": pts}


def dump(path: str, since: int = 0) -> None:
    """:func:`snapshot` and :func:`clock` as JSON."""
    with open(path, "w") as f:
        json.dump({"spans": snapshot(since), "clock": clock()}, f)


def recorder() -> Recorder:
    return _R
