"""Prometheus serving metrics.

Parity: reference zhilight/server/openai/engine/metrics.py:19-215 — gauges
(running/waiting), token counters, TTFT/TPOT/e2e histograms, periodic stat
logging.

The collectors are registered in a registry of this module's own, not in
``prometheus_client``'s process-global default one, so that this server can
run in a process that already registered the same names (the JAX package's
server, for one); ``/metrics`` renders that registry alone.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)

try:
    from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram, generate_latest

    PROM = True
except ImportError:  # pragma: no cover
    PROM = False

__all__ = ["ServingMetrics"]

_SINGLETON: Optional["ServingMetrics"] = None


class ServingMetrics:
    """One instance a process, so the counters add up across apps."""

    def __new__(cls, *a, **kw):
        global _SINGLETON
        if _SINGLETON is None:
            _SINGLETON = super().__new__(cls)
            _SINGLETON._init()
        return _SINGLETON

    def _init(self, labelname: str = "model"):
        if not PROM:
            return
        reg = self.registry = CollectorRegistry()
        self.gauge_running = Gauge("zhilight_requests_running", "running requests", registry=reg)
        self.gauge_waiting = Gauge("zhilight_requests_waiting", "queued requests", registry=reg)
        self.gauge_preemptions = Gauge(
            "zhilight_preemptions_total",
            "cumulative scheduler preemptions (KV swap/recompute)",
            registry=reg,
        )
        self.counter_prompt_tokens = Counter(
            "zhilight_prompt_tokens_total", "prompt tokens", registry=reg)
        self.counter_gen_tokens = Counter(
            "zhilight_generation_tokens_total", "generated tokens", registry=reg)
        self.hist_ttft = Histogram(
            "zhilight_time_to_first_token_seconds",
            "TTFT",
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0),
            registry=reg,
        )
        self.hist_tpot = Histogram(
            "zhilight_time_per_output_token_seconds",
            "TPOT",
            buckets=(0.005, 0.01, 0.02, 0.04, 0.08, 0.15, 0.3, 0.6, 1.2),
            registry=reg,
        )
        self.hist_e2e = Histogram(
            "zhilight_e2e_request_latency_seconds",
            "end-to-end latency",
            buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 40.0, 80.0),
            registry=reg,
        )
        self._last_log = time.monotonic()

    def observe_queue(self, running: int, waiting: int, preemptions: int = 0):
        if PROM:
            self.gauge_running.set(running)
            self.gauge_waiting.set(waiting)
            self.gauge_preemptions.set(preemptions)

    def observe_request(self, prompt_tokens: int, output: "GenerativeOutput"):
        if not PROM:
            return
        self.counter_prompt_tokens.inc(prompt_tokens)
        n = output.output_tokens_num
        self.counter_gen_tokens.inc(n)
        if output.first_token_delay:
            self.hist_ttft.observe(output.first_token_delay)
        if n > 1:
            self.hist_tpot.observe(
                (output.time_elapsed - output.first_token_delay) / max(n - 1, 1)
            )
        self.hist_e2e.observe(output.time_elapsed)

    def render(self) -> bytes:
        if not PROM:
            return b""
        return generate_latest(self.registry)
