# Tracing and metrics (DESIGN.md §Observability): injected-clock span
# timelines, one lock-safe metric registry, mergeable quantile sketches.
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, StatGroup,
                      labeled)
from .sketch import QuantileSketch
from .trace import Instant, Span, SpanNode, Tracer

__all__ = [k for k in dir() if not k.startswith("_")]
