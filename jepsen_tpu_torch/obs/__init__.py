"""The port's flight recorder: span tracing, metrics and the
device-search telemetry.

  * **spans** (:mod:`.trace`): where the wall clock went, recorded into
    bounded per-run ring buffers and exported as Chrome-trace JSON
    (:func:`chrome_trace`, :func:`write_trace`).  Off until
    :func:`enable` turns it on; off, a span costs one check.
  * **metrics** (:mod:`.metrics`): always-on counters, gauges and
    histograms under the JAX package's ``jtpu_*`` names, rendered as
    Prometheus text or a JSON snapshot.
  * **telemetry** (:mod:`.telemetry`): the per-level aux block of the
    device search and the ``search_telemetry`` result block.

:func:`log_ctx` stamps ``k=v`` context fields on log lines.
"""

from __future__ import annotations

import logging

from . import metrics  # noqa: F401
from . import telemetry  # noqa: F401
from .metrics import REGISTRY  # noqa: F401
from .trace import (DEFAULT_CAP, SpanRecorder, chrome_trace,  # noqa: F401
                    current_run, drop_recorder, enable, enabled,
                    recorder, set_run, span, traced, write_trace)


class _CtxAdapter(logging.LoggerAdapter):
    """Prefix every message with stable ``k=v`` context fields."""

    def process(self, msg, kwargs):
        ctx = " ".join(f"{k}={v}" for k, v in self.extra.items()
                       if v is not None)
        return (f"[{ctx}] {msg}" if ctx else msg), kwargs


def log_ctx(logger: logging.Logger, **fields) -> logging.LoggerAdapter:
    """``obs.log_ctx(log, run_id=r)``: an adapter whose lines carry the
    given context fields."""
    return _CtxAdapter(logger, fields)
