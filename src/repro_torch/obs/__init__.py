"""repro_torch.obs — the port's observability subsystem (a copy of the
reference's ``repro.obs``, pure Python, names and semantics unchanged).

* :mod:`repro_torch.obs.metrics` — thread-safe counters/gauges/histograms
  in a :class:`MetricsRegistry`; a process-global default registry of the
  port's own (not shared with the reference) for the cross-cutting
  families (``transfer_*``, shared ``compile_cache_*``) plus injectable
  per-session registries.
* :mod:`repro_torch.obs.trace` — structured span tracing on an injectable
  clock (``session.dispatch → device.execute``,
  ``retire.decode → rescue.rung``).
* :mod:`repro_torch.obs.export` — Prometheus text, JSON-lines, perfetto
  trace-event JSON.

The :class:`Obs` bundle is what components take: a registry + a tracer
that share an enabled/disabled fate.  ``plan(..., obs='off')`` resolves
to :data:`OBS_OFF`, whose metrics are the :data:`NULL_METRIC` singleton
and whose spans are the :data:`NULL_SPAN` singleton — the hot path then
costs a no-op method call per event and nothing else.  The trade is
explicit: ``obs='off'`` gives up ALL telemetry for that session
(``session.stats`` reads zeros) in exchange for zero overhead.
"""
from __future__ import annotations

from .export import (perfetto_trace, prometheus_text, trace_jsonl,
                     write_artifacts)
from .metrics import (DEFAULT_EDGES, Counter, Gauge, Histogram,
                      LabeledRegistry, MetricsRegistry, NULL_METRIC,
                      NULL_REGISTRY, NullRegistry, default_registry,
                      qualified_name)
from .trace import NULL_SPAN, NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Obs", "OBS_OFF", "resolve_obs",
    "MetricsRegistry", "LabeledRegistry", "NullRegistry", "NULL_REGISTRY",
    "Counter", "Gauge", "Histogram", "NULL_METRIC", "DEFAULT_EDGES",
    "Tracer", "NullTracer", "Span", "NULL_SPAN", "NULL_TRACER",
    "prometheus_text", "trace_jsonl", "perfetto_trace", "write_artifacts",
    "default_registry", "qualified_name",
]


class Obs:
    """One observability domain: a metrics registry + a span tracer.

    Components hold an ``Obs`` and ask it for metrics/spans; callers
    choose the scope by choosing which ``Obs`` to inject (a private one
    per session by default, one shared bundle across a benchmark run,
    or :data:`OBS_OFF`)."""

    __slots__ = ("registry", "tracer")

    def __init__(self, registry, tracer):
        self.registry = registry
        self.tracer = tracer

    @property
    def enabled(self) -> bool:
        return self.registry.enabled

    @staticmethod
    def private(clock=None, maxlen: int = 8192) -> "Obs":
        """A fresh enabled bundle (own registry, own tracer on ``clock``)."""
        return Obs(MetricsRegistry(), Tracer(clock=clock, maxlen=maxlen))

    # -- convenience passthroughs ------------------------------------
    def counter(self, name: str, **labels):
        return self.registry.counter(name, **labels)

    def gauge(self, name: str, **labels):
        return self.registry.gauge(name, **labels)

    def histogram(self, name: str, edges=DEFAULT_EDGES, **labels):
        return self.registry.histogram(name, edges=edges, **labels)

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def labeled(self, **labels) -> "Obs":
        """Same tracer, a constant-label view of the registry."""
        return Obs(self.registry.labeled(**labels), self.tracer)

    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def prometheus(self) -> str:
        return prometheus_text(self.registry)

    def perfetto(self) -> dict:
        return perfetto_trace(self.tracer)

    def jsonl(self) -> str:
        return trace_jsonl(self.tracer)

    def reset(self) -> None:
        self.registry.reset()
        self.tracer.reset()


#: The disabled bundle — every metric is NULL_METRIC, every span is
#: NULL_SPAN.  Shared and stateless, so one instance serves the process.
OBS_OFF = Obs(NULL_REGISTRY, NULL_TRACER)


def resolve_obs(obs, clock=None) -> Obs:
    """Normalise the ``obs=`` argument components accept:

    * ``None`` → a fresh private enabled bundle (tracer on ``clock``);
    * ``'off'`` / ``False`` → :data:`OBS_OFF`;
    * an :class:`Obs` → itself (caller-scoped sharing).
    """
    if obs is None:
        return Obs.private(clock=clock)
    if obs is False or obs == "off":
        return OBS_OFF
    if isinstance(obs, Obs):
        return obs
    raise TypeError(f"obs must be None, 'off', or an Obs bundle; got "
                    f"{obs!r}")
