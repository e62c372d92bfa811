# Unified tracing + metrics layer (DESIGN.md §Observability): deterministic
# span timelines from injected clocks, one lock-safe metric registry, Chrome
# trace-event (Perfetto) export with flow events, added-TTFT attribution,
# and the online half — mergeable quantile sketches, streaming windowed
# metrics, SLO burn-rate monitors, critical-path profiles, and the
# perf-trajectory regression gate.
from .attribution import (REQUEST_SUMMARY, TTFTAttribution, attribute_flow,
                          attribute_trace, check_identity, format_attribution)
from .critical_path import (CriticalPath, PathSegment, Projection,
                            aggregate_profile, extract_all,
                            extract_critical_path, format_profile,
                            project_request, project_wire_scale)
from .export import (assert_valid_chrome_trace, render_waterfall,
                     to_chrome_trace, validate_chrome_trace,
                     write_chrome_trace)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, StatGroup,
                      labeled)
from .regress import (bench_result, bench_result_from_csv, compare,
                      format_report, metric_direction, parse_derived,
                      rows_from_csv, validate_bench_result,
                      write_bench_result)
from .sketch import QuantileSketch
from .slo import SLOMonitor, SLOTarget
from .trace import Instant, Span, SpanNode, Tracer
from .window import (Ewma, MultiMonitor, StreamMonitor, Window,
                     WindowedSeries, window_index)

__all__ = [k for k in dir() if not k.startswith("_")]
