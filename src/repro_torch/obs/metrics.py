"""Thread-safe, low-overhead metrics registry (counters, gauges,
histograms with fixed bucket edges).

* A :class:`MetricsRegistry` hands out **named, labelled metric objects**
  memoised by (name, labels): asking twice returns the same object, so a
  hot path fetches its counters ONCE at init and pays only a locked
  ``+=`` per event afterwards (increments are locked because the exact
  1-upload/1-download and build-count assertions must survive the
  session's retire thread racing the dispatch thread).
* ``registry.labeled(session="a")`` returns a **view** that stamps a
  constant label set onto every metric it vends — how several sessions
  share one registry without colliding, while each still reads back only
  its own counters.
* :data:`NULL_REGISTRY` is the **disabled** registry: every request
  returns the one :data:`NULL_METRIC` singleton whose mutators do
  nothing — no allocation, no lock, no branch at the call site — so an
  obs-disabled serving path costs a method call per event and nothing
  else.

Reads (``.value``) are deliberately lock-free: a single attribute load
of a Python int/float is atomic under the GIL, and exporters tolerate
point-in-time skew between metrics.  Values are cumulative since
construction; ``reset()`` exists because the transfer-counter contract
(``core.transfer.reset()``) is per-family, not registry-wide.
"""
from __future__ import annotations

import bisect
import threading

#: Fixed default histogram edges (seconds): latency-shaped, 1ms..10s.
#: Fixed at construction — Prometheus-style cumulative buckets only make
#: sense when every observation falls into a stable edge set.
DEFAULT_EDGES = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0)


def qualified_name(name: str, labels: tuple) -> str:
    """``name{k="v",...}`` — the snapshot/export key for one metric."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter (ints or float seconds).  ``inc`` is exact under
    concurrent threads (locked read-modify-write); ``value`` is a single
    atomic read."""

    kind = "counter"
    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snap(self):
        return self._value

    def __repr__(self):
        return f"Counter({qualified_name(self.name, self.labels)}=" \
               f"{self._value})"


class Gauge:
    """Up/down instantaneous value (queue depths, in-flight counts)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    def add(self, n=1) -> None:
        with self._lock:
            self._value += n

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    @property
    def value(self):
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def snap(self):
        return self._value

    def __repr__(self):
        return f"Gauge({qualified_name(self.name, self.labels)}=" \
               f"{self._value})"


class Histogram:
    """Fixed-edge histogram (Prometheus-style cumulative buckets).

    ``edges`` are the upper bounds of the finite buckets; one implicit
    ``+Inf`` bucket catches the rest.  ``observe`` is O(log n_edges)
    under the lock."""

    kind = "histogram"
    __slots__ = ("name", "labels", "edges", "_lock", "_counts", "_sum",
                 "_count")

    def __init__(self, name: str, labels: tuple = (),
                 edges: tuple = DEFAULT_EDGES):
        assert tuple(edges) == tuple(sorted(edges)) and len(edges) >= 1, \
            edges
        self.name = name
        self.labels = labels
        self.edges = tuple(float(e) for e in edges)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.edges) + 1)   # [..., +Inf]
        self._sum = 0.0
        self._count = 0

    def observe(self, v) -> None:
        i = bisect.bisect_left(self.edges, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.edges) + 1)
            self._sum = 0.0
            self._count = 0

    def snap(self) -> dict:
        """{"buckets": {edge: cumulative_count, "+Inf": total}, "sum",
        "count"} — cumulative, the Prometheus exposition shape."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum, out = 0, {}
        for e, n in zip(self.edges, counts):
            cum += n
            out[repr(e)] = cum
        out["+Inf"] = cum + counts[-1]
        return {"buckets": out, "sum": s, "count": c}

    def __repr__(self):
        return f"Histogram({qualified_name(self.name, self.labels)} " \
               f"count={self._count} sum={self._sum:.6g})"


class _NullMetric:
    """The disabled metric: one process-wide singleton serving as counter,
    gauge AND histogram — every mutator is a no-op, every read is zero.
    Identity is the contract (``registry.counter(...) is NULL_METRIC``):
    a disabled hot path holds this object and pays one no-op method call
    per event, allocating nothing."""

    kind = "null"
    __slots__ = ()
    value = 0
    count = 0
    sum = 0.0
    name = "<null>"
    labels = ()
    edges = ()

    def inc(self, n=1) -> None:
        pass

    def add(self, n=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def reset(self) -> None:
        pass

    def snap(self):
        return 0


NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Process- or session-scoped metric store.

    One registry per observability domain: the process-global default
    (``repro_torch.obs.default_registry()``) carries the cross-cutting families
    (host<->device transfers, the shared compile cache); each
    :class:`~repro_torch.api.AlignSession` gets its own injectable registry so
    N tenants never collide and a snapshot is one tenant's whole story.
    """

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}      # (name, labels) -> metric

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[1], **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {qualified_name(name, key[1])} already "
                    f"registered as {m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, edges: tuple = DEFAULT_EDGES,
                  **labels) -> Histogram:
        h = self._get(Histogram, name, labels, edges=edges)
        if h.edges != tuple(float(e) for e in edges):
            raise ValueError(
                f"histogram {name} already registered with edges "
                f"{h.edges}, requested {edges} (edges are fixed)")
        return h

    def labeled(self, **labels) -> "LabeledRegistry":
        """A view stamping constant labels on every metric it vends —
        several components share one registry without name collisions."""
        return LabeledRegistry(self, labels)

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """{qualified_name: value-or-histogram-dict} for every metric —
        the one structure exporters, benchmarks and the legacy-accessor
        equality tests read."""
        return {qualified_name(m.name, m.labels): m.snap()
                for m in self.metrics()}

    def reset(self) -> None:
        for m in self.metrics():
            m.reset()


class LabeledRegistry:
    """Constant-label view over a base registry (see
    :meth:`MetricsRegistry.labeled`).  Shares the base's storage; its own
    ``snapshot()`` is filtered to metrics carrying the view's labels."""

    enabled = True

    def __init__(self, base, labels: dict):
        self._base = base
        self._labels = dict(labels)

    def counter(self, name: str, **labels) -> Counter:
        return self._base.counter(name, **{**self._labels, **labels})

    def gauge(self, name: str, **labels) -> Gauge:
        return self._base.gauge(name, **{**self._labels, **labels})

    def histogram(self, name: str, edges: tuple = DEFAULT_EDGES,
                  **labels) -> Histogram:
        return self._base.histogram(name, edges=edges,
                                    **{**self._labels, **labels})

    def labeled(self, **labels) -> "LabeledRegistry":
        return LabeledRegistry(self._base, {**self._labels, **labels})

    def metrics(self) -> list:
        want = set(self._labels.items())
        return [m for m in self._base.metrics()
                if want <= set(m.labels)]

    def snapshot(self) -> dict:
        return {qualified_name(m.name, m.labels): m.snap()
                for m in self.metrics()}

    def reset(self) -> None:
        for m in self.metrics():
            m.reset()


class NullRegistry:
    """The disabled registry: vends :data:`NULL_METRIC` for everything.
    ``enabled`` is False so call sites that must skip even the no-op
    (e.g. building a label dict) can branch once at init."""

    enabled = False

    def counter(self, name: str, **labels):
        return NULL_METRIC

    def gauge(self, name: str, **labels):
        return NULL_METRIC

    def histogram(self, name: str, edges: tuple = DEFAULT_EDGES,
                  **labels):
        return NULL_METRIC

    def labeled(self, **labels) -> "NullRegistry":
        return self

    def metrics(self) -> list:
        return []

    def snapshot(self) -> dict:
        return {}

    def reset(self) -> None:
        pass


NULL_REGISTRY = NullRegistry()

_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry: cross-cutting counter families
    (``transfer_*``, the shared ``compile_cache_*``) live here; sessions
    get their own (see repro_torch.obs.Obs)."""
    return _DEFAULT
