"""The fleet router: one URL in front of N serving replicas.

Counterpart of ``learningorchestra_tpu/serve/router.py``, module and
public names kept. The router is placement-aware:
``POST /models/<name>/predict`` resolves the model's owners on the
consistent-hash ring (``serve/fleet.PlacementClient``, the same
rev-cached map the replica agents pin by), orders them healthy-first
from the residency gossip (``serve/fleet.FleetView``), and returns an
``utils/web.Upstream``: on the event loop the proxy rides the loop
itself (no thread held), failing over to the next owner on connection
death or a 5xx.

An optional per-model token bucket (``LO_FLEET_MODEL_QPS``) answers
``429`` + ``Retry-After`` before any socket is opened, so one hot model
cannot starve its neighbours' replicas. ``GET /models/<name>`` answers
the fleet residency picture: owners, per-replica heartbeat (pinned
models and bytes, inflight, health) and the placement rev.
``GET /health`` carries ``"fleet_router": true``, the probe the client
detects a router by.

Metric families: ``lo_router_requests_total``,
``lo_router_retries_total``, ``lo_router_rejected_total``,
``lo_router_request_seconds``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

from learningorchestra_tpu_torch.serve import fleet as _fleet
from learningorchestra_tpu_torch.testing import faults
from learningorchestra_tpu_torch.utils.web import Response, Upstream, WebApp

DEFAULT_TIMEOUT_S = 30.0


def _correlation_header() -> str:
    from learningorchestra_tpu_torch.telemetry import tracing as _tracing

    return _tracing.CORRELATION_HEADER


class ModelQuota:
    """Per-model token bucket: ``rate`` requests/s refill, burst of one
    second's worth (min 1). ``rate=0`` disables admission control —
    :meth:`take` always admits."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self.burst = max(self.rate, 1.0)
        self._lock = threading.Lock()
        self._buckets: dict[str, tuple[float, float]] = {}

    def take(self, model: str) -> Optional[float]:
        """Admit one request for ``model``: ``None`` when admitted,
        else the seconds until a token is available (the Retry-After
        value)."""
        if self.rate <= 0:
            return None
        now = time.monotonic()
        with self._lock:
            tokens, stamp = self._buckets.get(model, (self.burst, now))
            tokens = min(self.burst, tokens + (now - stamp) * self.rate)
            if tokens >= 1.0:
                self._buckets[model] = (tokens - 1.0, now)
                return None
            self._buckets[model] = (tokens, now)
            return round((1.0 - tokens) / self.rate, 3)


def _raw_predict_request(model_name: str, body: bytes, correlation_id=None) -> bytes:
    """The request bytes replayed verbatim against each owner.
    ``Connection: close`` keeps the relay's response framing
    unambiguous (EOF terminates when the backend omits
    Content-Length) and means a failover never reuses a socket that
    already saw half a request."""
    head = (
        f"POST /models/{model_name}/predict HTTP/1.1\r\n"
        "Host: fleet\r\n"
        "Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n"
        "Connection: close\r\n"
    )
    if correlation_id:
        from learningorchestra_tpu_torch.telemetry import tracing as _tracing

        head += f"{_tracing.CORRELATION_HEADER}: {correlation_id}\r\n"
    return head.encode("ascii") + b"\r\n" + body


def create_app(
    store,
    placement: Optional[_fleet.PlacementClient] = None,
    view: Optional[_fleet.FleetView] = None,
    quota: Optional[ModelQuota] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> WebApp:
    """The router's app. ``store`` is the meta store carrying the
    ``__lo_placement__`` map and ``__lo_fleet__`` gossip; everything
    else defaults from the fleet knobs."""
    app = WebApp("router")
    placement = placement or _fleet.PlacementClient(store)
    view = view or _fleet.FleetView(store)
    quota = quota or ModelQuota(_fleet.model_qps())
    metrics = _router_metrics(app.registry)
    app.fleet_placement = placement
    app.fleet_view = view

    def ordered_targets(name: str) -> list[tuple[str, int]]:
        """The model's owners as connectable targets, healthy replicas
        first — a replica whose heartbeat went stale is still LAST
        resort (it may be alive with a wedged gossip thread), but
        never the first socket opened."""
        owners = placement.owners(name)
        ordered = [i for i in owners if view.healthy(i)]
        ordered += [i for i in owners if i not in ordered]
        targets = []
        for index in ordered:
            target = view.target(index)
            if target is not None:
                targets.append(target)
        return targets

    @app.route("/health")
    def health(request):
        return {
            "result": "ok",
            "service": app.name,
            # feature probe: the client's Model detects a router base
            # URL by this field and routes predicts through the fleet
            "fleet_router": True,
            "replicas": placement.document()["replicas"],
            "degraded": app.slo_degraded(),
        }, 200

    @app.route("/models/<model_name>", methods=("GET",))
    def read_model_fleet(request, model_name):
        """The residency picture: who OWNS the model (placement), who
        actually HOLDS it right now (gossip), and the placement rev the
        answer was computed at."""
        owners = placement.owners(model_name)
        residency = view.residency()
        return {
            "result": {
                "model": model_name,
                "fleet": {
                    "owners": owners,
                    "rf": placement.document()["rf"],
                    "replicas": residency,
                    "placement_rev": placement.rev,
                },
            }
        }, 200

    @app.route("/models/<model_name>/predict", methods=("POST",))
    def route_predict(request, model_name):
        retry_after = quota.take(model_name)
        if retry_after is not None:
            metrics["rejected"].labels(model_name).inc()
            return app_quota_response(model_name, retry_after)
        try:
            faults.fire("serve.route", model=model_name)
        except faults.FaultInjected:
            # chaos parity with the store wire: an injected routing
            # fault answers a clean JSON 503, never a traceback
            return {"result": "routing_fault", "model": model_name}, 503
        targets = ordered_targets(model_name)
        if not targets:
            return {"result": "no_replicas", "model": model_name}, 503
        metrics["requests"].labels(model_name).inc()
        started = time.perf_counter()

        def on_attempt(index, target, _model=model_name):
            if index > 0:
                metrics["retries"].labels(_model).inc()

        def on_complete(status, _started=started):
            metrics["seconds"].observe(time.perf_counter() - _started)

        upstream = Upstream(
            targets,
            _raw_predict_request(
                model_name,
                request.get_data(),
                request.headers.get(_correlation_header()),
            ),
            timeout_s=timeout_s,
            on_attempt=on_attempt,
            on_exhausted=lambda: (
                {"result": "no_replicas", "model": model_name},
                503,
            ),
        )
        upstream.on_complete = on_complete
        return upstream

    return app


def app_quota_response(model_name: str, retry_after_s: float):
    """429 + Retry-After, the serving plane's admission-control shape
    (utils/web.too_many_requests) with the quota's drain estimate."""
    return Response(
        json.dumps(
            {
                "result": "quota_exceeded",
                "model": model_name,
                "retry_after_s": retry_after_s,
            }
        ),
        status=429,
        headers={"Retry-After": str(retry_after_s)},
    )


_METRICS: Optional[dict] = None
_METRICS_LOCK = threading.Lock()


def _router_metrics(registry) -> dict:
    """Router families, declared once per process."""
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            _METRICS = {
                "requests": registry.counter(
                    "lo_router_requests_total",
                    "Predict requests admitted and proxied",
                    labels=("model",),
                ),
                "retries": registry.counter(
                    "lo_router_retries_total",
                    "Failover attempts past a model's first owner",
                    labels=("model",),
                ),
                "rejected": registry.counter(
                    "lo_router_rejected_total",
                    "Predict requests rejected by the per-model quota",
                    labels=("model",),
                ),
                "seconds": registry.histogram(
                    "lo_router_request_seconds",
                    "Routed predict wall-clock, admission to relay",
                ),
            }
        return _METRICS
