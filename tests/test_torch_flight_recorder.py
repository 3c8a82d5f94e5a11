"""The flight recorder and the observability plane, each package against
the other on the same seeded inputs, on the CPU.

- ``chrome_trace`` and ``trace_summary`` of one span tree;
- ``parse_samples``, ``history``, ``rollup``, ``window_rollups`` and
  ``slo.evaluate`` over the same exposition texts, tick by tick;
- ``stitched_trace`` over the same members' span groups;
- the span names of a Titanic five-classifier build through each
  package's model_builder app (less the reference's jax-only spans,
  :data:`JAX_ONLY_SPANS`);
- every error answer of the observability routes, status and body byte
  for byte;
- ``lo_h2d_bytes_total`` against ``ml/base.h2d_bytes()`` over a build,
  and a cached repeat of a batch request that adds nothing to either;
- ``lo_d2h_bytes_total`` against every ``Tensor.cpu()`` of a build;
- ``lo_kernel_launches_total``, fed by the kernels' launch counts.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from learningorchestra_tpu.core.jobs import JobManager as JaxJobManager
from learningorchestra_tpu.core.store import InMemoryStore as JaxStore
from learningorchestra_tpu.serve.batcher import LATENCY_BUCKETS as JAX_LATENCY_BUCKETS
from learningorchestra_tpu.telemetry import profile as jax_profile
from learningorchestra_tpu.telemetry import slo as jax_slo
from learningorchestra_tpu.telemetry import stitch as jax_stitch
from learningorchestra_tpu.telemetry import tracing as jax_tracing
from learningorchestra_tpu.telemetry import tsdb as jax_tsdb
from learningorchestra_tpu.utils.web import WebApp as JaxWebApp
from learningorchestra_tpu_torch.core import devcache
from learningorchestra_tpu_torch.core.jobs import JobManager as PortJobManager
from learningorchestra_tpu_torch.core.store import InMemoryStore as PortStore
from learningorchestra_tpu_torch.ml import base
from learningorchestra_tpu_torch.serve.batcher import LATENCY_BUCKETS
from learningorchestra_tpu_torch.telemetry import profile
from learningorchestra_tpu_torch.telemetry import slo
from learningorchestra_tpu_torch.telemetry import stitch
from learningorchestra_tpu_torch.telemetry import tracing
from learningorchestra_tpu_torch.telemetry import tsdb
from learningorchestra_tpu_torch.utils.web import WebApp as PortWebApp
from tests.torch_card_copies import count_cpu_copies

FIVE = ["lr", "dt", "rf", "gb", "nb"]
NUMERIC_FIELDS = ("PassengerId", "Survived", "Pclass", "Age", "SibSp", "Parch", "Fare")
# spans only the reference's build opens: "devices" times its first
# jax.process_count() (the XLA backend's start), which the port has no
# counterpart of
JAX_ONLY_SPANS = {"devices"}
REPO_ROOT = str(Path(__file__).resolve().parent.parent)


def seeded_trace(seed: int = 3) -> dict:
    """A span tree as ``Trace.as_dict()`` gives it: three threads, nested
    spans with rows and wire, h2d, d2h and payload bytes, one span
    still open (no duration)."""
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000.0
    names = ["load_data", "wire:read", "h2d:matrix", "phase:fit", "d2h:predictions", "phase:write"]

    def span(depth: int) -> dict:
        start = t0 + float(rng.uniform(0, 5))
        meta = {"rows": int(rng.integers(1, 10_000))}
        for attr in ("wire_bytes", "h2d_bytes", "d2h_bytes", "bytes"):
            if rng.random() < 0.5:
                meta[attr] = int(rng.integers(1, 1 << 20))
        return {
            "name": names[int(rng.integers(len(names)))],
            "start_ts": start,
            "duration_s": None if rng.random() < 0.1 else float(rng.uniform(0, 2)),
            "tid": int(rng.integers(1, 4)),
            "meta": meta,
            "children": [span(depth + 1) for _ in range(int(rng.integers(0, 3)) if depth < 3 else 0)],
        }

    return {"correlation_id": "cid_seeded", "name": "build:seeded", "spans": [span(0) for _ in range(6)]}


def test_chrome_trace_and_summary_equal_the_reference():
    trace = seeded_trace()
    ours, theirs = profile.chrome_trace(trace), jax_profile.chrome_trace(trace)
    # pid aside: both run in this process, and a span's pid is its process's
    for events in (ours["traceEvents"], theirs["traceEvents"]):
        for event in events:
            event.pop("pid", None)
    assert ours == theirs
    assert ours["otherData"]["bytes_total"]["h2d_bytes"] > 0
    assert profile.trace_summary(trace) == jax_profile.trace_summary(trace)


def exposition_ticks(seed: int = 11, ticks: int = 14) -> list:
    """Prometheus texts of two instances over ``ticks`` scrapes: request
    counters (some 5xx), a queue-depth and a replication-lag gauge, and
    a serving-latency histogram, every value drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    state = {
        instance: {"ok": 0.0, "err": 0.0, "buckets": np.zeros(len(LATENCY_BUCKETS) + 1), "sum": 0.0}
        for instance in ("10.0.0.1:5002", "10.0.0.2:5002")
    }
    out = []
    for tick in range(ticks):
        for instance, s in state.items():
            s["ok"] += float(rng.integers(0, 50))
            s["err"] += float(rng.integers(0, 3))
            latencies = rng.exponential(0.05 * (1 + tick % 4), size=int(rng.integers(0, 40)))
            for value in latencies:
                s["buckets"][np.searchsorted(LATENCY_BUCKETS, value)] += 1
                s["sum"] += float(value)
            cumulative = np.cumsum(s["buckets"])
            lines = [
                "# TYPE lo_http_requests_total counter",
                f'lo_http_requests_total{{service="model_builder",route="/x",status="200"}} {s["ok"]}',
                f'lo_http_requests_total{{service="model_builder",route="/x",status="503"}} {s["err"]}',
                f"lo_sched_queue_depth {float(rng.integers(0, 100))}",
                f"lo_store_replication_lag {float(rng.integers(0, 2_000))}",
            ]
            for le, count in zip([*map(str, LATENCY_BUCKETS), "+Inf"], cumulative):
                lines.append(f'lo_serve_request_seconds_bucket{{le="{le}"}} {float(count)}')
            lines += [f"lo_serve_request_seconds_sum {s['sum']}", f"lo_serve_request_seconds_count {cumulative[-1]}"]
            out.append((instance, 1_000.0 + 30.0 * tick, "\n".join(lines) + "\n"))
    return out


def test_tsdb_rollups_and_slo_equal_the_reference(monkeypatch):
    assert LATENCY_BUCKETS == JAX_LATENCY_BUCKETS
    monkeypatch.setenv("LO_SLO_SERVE_P99_S", "0.2")
    monkeypatch.setenv("LO_SLO_WINDOW_S", "120")
    ours, theirs = PortStore(), JaxStore()
    ours_db, theirs_db = tsdb.TSDB(ours, points=8), jax_tsdb.TSDB(theirs, points=8)
    for instance, ts, text in exposition_ticks():
        vals = tsdb.parse_samples(text)
        assert vals == jax_tsdb.parse_samples(text)
        assert ours_db.append(instance, "model_builder", vals, ts=ts) == theirs_db.append(
            instance, "model_builder", vals, ts=ts)
        for family in ("lo_http_requests_total", tsdb.DERIVED_5XX, "lo_sched_queue_depth",
                       "lo_serve_request_seconds"):
            series = tsdb.history(ours, family)
            assert series == jax_tsdb.history(theirs, family)
            for points in series.values():
                for window in (60.0, 600.0):
                    assert tsdb.rollup(family, points, window_s=window) == jax_tsdb.rollup(
                        family, points, window_s=window)
            assert tsdb.window_rollups(ours, family, window_s=90.0) == jax_tsdb.window_rollups(
                theirs, family, window_s=90.0)
        assert slo.evaluate(ours, now=ts) == jax_slo.evaluate(theirs, now=ts)
    assert tsdb.services_of(ours) == jax_tsdb.services_of(theirs)
    assert slo.evaluate(ours)["burning"], "the seeded latencies never burned a rule"


def test_stitched_trace_equals_the_reference(monkeypatch):
    rng = np.random.default_rng(5)
    groups = {}
    for service, pid in (("database_api", 101), ("histogram", 102), ("model_builder", 103)):
        groups[f"{service}@{pid}"] = {
            "service": service, "pid": pid,
            "spans": [
                {"name": f"{service}:work{i}", "start_ts": float(rng.uniform(100, 110)),
                 "duration_s": float(rng.uniform(0, 1)), "tid": int(rng.integers(1, 5)),
                 "meta": {"rows": int(rng.integers(1, 100))}, "children": []}
                for i in range(3)
            ],
        }

    def fetch(base_url, cid, since=None):
        return {key: group for key, group in groups.items() if key.startswith(base_url.rsplit("/", 1)[1])}

    monkeypatch.setattr(stitch, "fetch_member_spans", fetch)
    monkeypatch.setattr(jax_stitch, "fetch_member_spans", fetch)
    members = ["http://h/database_api", "http://h/histogram", "http://h/model_builder"]
    ours = stitch.stitched_trace("cid_nobody_exported", members=members)
    theirs = jax_stitch.stitched_trace("cid_nobody_exported", members=members)
    assert ours == theirs
    assert len(ours["otherData"]["processes"]) == 3


def _warmups_settled(client, count: int, timeout_s: float = 60) -> None:
    """Wait until ``count`` publish-time warmup jobs (``warmup:<file>``)
    of an app have ended."""
    deadline = time.monotonic() + timeout_s
    jobs: list = []
    while time.monotonic() < deadline:
        jobs = [job for job in client.get("/jobs").get_json()["result"] if job["name"].startswith("warmup:")]
        if len(jobs) >= count and all(job["state"] in ("finished", "failed", "cancelled") for job in jobs):
            return
        time.sleep(0.02)
    raise AssertionError(f"the warmups never ended: {jobs}")


def _titanic_apps(tmp_path):
    """A store and a model_builder app of each package over the same
    Titanic-like CSV, cast as the golden flow casts it."""
    from learningorchestra_tpu.core.ingest import ingest_csv as jax_ingest
    from learningorchestra_tpu.core.ingest import write_ingest_metadata as jax_metadata
    from learningorchestra_tpu.ops.dtype import convert_field_types as jax_convert
    from learningorchestra_tpu.services import model_builder as jax_builder
    from learningorchestra_tpu_torch.core.ingest import ingest_csv, write_ingest_metadata
    from learningorchestra_tpu_torch.ops.dtype import convert_field_types
    from learningorchestra_tpu_torch.services import model_builder
    from tests.conftest import TITANIC_LIKE_CSV

    path = tmp_path / "titanic.csv"
    path.write_text(TITANIC_LIKE_CSV)
    stores = {"port": PortStore(), "jax": JaxStore()}
    for side, (write, ingest, convert) in {
        "port": (write_ingest_metadata, ingest_csv, convert_field_types),
        "jax": (jax_metadata, jax_ingest, jax_convert),
    }.items():
        for name in ("titanic_train", "titanic_test"):
            write(stores[side], name, str(path))
            ingest(stores[side], name, str(path))
            convert(stores[side], name, {field: "number" for field in NUMERIC_FIELDS})
    apps = {
        "port": model_builder.create_app(
            stores["port"], models_dir=str(tmp_path / "port"), jobs=PortJobManager(), device="cpu"),
        "jax": jax_builder.create_app(stores["jax"], models_dir=str(tmp_path / "jax"), jobs=JaxJobManager()),
    }
    return stores, apps


def _span_names(span_list) -> set:
    names = set()
    for span in span_list:
        names.add(span["name"])
        names |= _span_names(span["children"])
    return names


def build_span_names(tmp_path) -> dict:
    """Each package's five-classifier Titanic build through its
    model_builder app: the span names of the job's trace, and the
    ``phase:fit`` events of its profile's Chrome trace. Both device
    caches start empty."""
    from learningorchestra_tpu.core import devcache as jax_devcache
    from tests.test_frame import DOCUMENTED_PREPROCESSOR

    devcache.reset_global_devcache()
    jax_devcache.reset_global_devcache()
    _, apps = _titanic_apps(tmp_path)
    names, fits = {}, {}
    for side, app in apps.items():
        client = app.test_client()
        response = client.post("/models", json={
            "training_filename": "titanic_train", "test_filename": "titanic_test",
            "preprocessor_code": DOCUMENTED_PREPROCESSOR, "classificators_list": FIVE,
        }, headers={"X-Correlation-Id": f"build_{side}"})
        assert response.status_code == 201, response.get_data()
        job = f"build:titanic_test:{'+'.join(FIVE)}"
        trace = client.get(f"/jobs/{job}/trace").get_json()["result"]["trace"]
        names[side] = sorted(_span_names(trace["spans"]))
        chrome = json.loads(client.get(f"/jobs/{job}/profile").get_data())
        fits[side] = sum(1 for e in chrome["traceEvents"] if e["ph"] == "X" and e["name"] == "phase:fit")
    return {"names": names, "fits": fits}


# Both builds run in a fresh process. Once the reference's
# jax.monitoring listeners are on (utils/jitcache._register_listeners:
# tests/test_compile.py's cache_dir fixture turns them on), it books a
# ``compile:backend`` span for every XLA compile a build makes. The
# listeners are process-wide and never removed, so in the test process
# the reference's span set would depend on what ran before on the worker.
_BUILD_SPANS_PROBE = """
import json, os, pathlib, sys
from tests.test_torch_flight_recorder import build_span_names
print(json.dumps(build_span_names(pathlib.Path(sys.argv[1]))), flush=True)
# the builds' pool threads can abort the interpreter's shutdown
os._exit(0)
"""


def test_a_build_opens_the_reference_spans(tmp_path):
    """The five-classifier build's job trace names the same spans in both
    packages, and its profile's Chrome trace has a ``phase:fit`` event a
    classifier. Both device caches start empty: a cached matrix opens no
    ``h2d:*`` span."""
    result = subprocess.run(
        [sys.executable, "-c", _BUILD_SPANS_PROBE, str(tmp_path)], capture_output=True, text=True,
        cwd=REPO_ROOT, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu", LO_BUILD_WORKERS="1"),
    )
    assert result.returncode == 0, result.stderr
    probe = json.loads(result.stdout.strip().splitlines()[-1])
    names = {side: set(found) for side, found in probe["names"].items()}
    for side, fits in probe["fits"].items():
        assert fits == len(FIVE), side
    assert names["jax"] & JAX_ONLY_SPANS == JAX_ONLY_SPANS
    assert names["port"] == names["jax"] - JAX_ONLY_SPANS
    assert {"load_data", "preprocess", "d2h:predictions", "h2d:matrix", "phase:fit"} <= names["port"]


class _BrokenStore:
    """A store mid-failover: every read raises."""

    def collection_rev(self, collection):
        raise RuntimeError("store unreachable")

    def find(self, collection, query=None):
        raise RuntimeError("store unreachable")


def _apps_for_errors():
    apps = {}
    for side, (web_app, jobs_class, store) in {
        "port": (PortWebApp, PortJobManager, PortStore()),
        "jax": (JaxWebApp, JaxJobManager, JaxStore()),
    }.items():
        app = web_app("errors")
        jobs = jobs_class()
        app.register_job_routes(jobs)
        app.register_observability(store)
        record = jobs.run_sync("traceless", lambda: None)
        jobs.get("traceless").trace = None
        broken = web_app("broken")
        broken.register_observability(_BrokenStore())
        apps[side] = (app.test_client(), broken.test_client())
        del record
    return apps


ERROR_REQUESTS = (
    ("GET", "/debug/profile?seconds=abc", None, "bad_seconds"),
    ("GET", "/debug/profile?seconds=-1", None, "bad_seconds"),
    ("GET", "/debug/profile?seconds=nan", None, "bad_seconds"),
    ("GET", "/debug/spans?since=yesterday", None, "bad_since"),
    ("GET", "/traces/no_such_cid", None, "not_found"),
    ("GET", "/jobs/no_such_job/profile", None, "not_found"),
    ("GET", "/jobs/no_such_job/profile?format=summary", None, "not_found"),
    ("GET", "/jobs/traceless/profile", None, "no_trace"),
    ("GET", "/metrics/history", None, "bad_family"),
    ("GET", "/metrics/history?family=lo_x&window=wide", None, "bad_window"),
    ("GET", "/metrics/history?family=lo_x&since=later", None, "bad_window"),
    ("POST", "/metrics/ingest", {"text": "lo_x 1\n"}, "bad_ingest"),
    ("POST", "/metrics/ingest", {"instance": "i", "text": 7}, "bad_ingest"),
    ("POST", "/metrics/ingest", {"instance": "i", "text": "lo_x 1e\n"}, "unparseable"),
    ("POST", "/metrics/ingest", {"instance": "i", "text": 'lo_x_bucket{a="b"} 3\n'}, "unparseable"),
)


@pytest.mark.parametrize("method,path,payload,result", ERROR_REQUESTS)
def test_error_answers_are_the_reference_bytes(method, path, payload, result):
    apps = _apps_for_errors()
    answers = {}
    for side, (client, _) in apps.items():
        response = client.get(path) if method == "GET" else client.post(path, json=payload)
        answers[side] = (response.status_code, response.get_data())
    assert answers["port"] == answers["jax"]
    assert json.loads(answers["port"][1])["result"] == result


@pytest.mark.parametrize("hz,result,status", [("0", "profiler_disabled", 403), ("fast", "invalid_prof_config", 500)])
def test_profiler_refusals_are_the_reference_bytes(monkeypatch, hz, result, status):
    monkeypatch.setenv("LO_PROF_HZ", hz)
    answers = {side: client.get("/debug/profile?seconds=1") for side, (client, _) in _apps_for_errors().items()}
    got = {side: (r.status_code, r.get_data()) for side, r in answers.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == status and json.loads(got["port"][1])["result"] == result


def test_slo_unavailable_is_the_reference_bytes():
    answers = {side: broken.get("/debug/slo") for side, (_, broken) in _apps_for_errors().items()}
    got = {side: (r.status_code, r.get_data()) for side, r in answers.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == 503 and json.loads(got["port"][1]) == {
        "result": "slo_unavailable", "error": "RuntimeError: store unreachable"}


def test_h2d_counter_is_the_funnels_count(tmp_path, monkeypatch):
    """Over a CPU build (the CPU's copies counted, as on a card), the
    flight recorder's ``lo_h2d_bytes_total`` moves by what
    ``h2d_bytes()`` counts; a batch request repeated over unchanged
    collections is answered by the device cache and adds nothing to
    either."""
    from learningorchestra_tpu_torch.ml import builder
    from tests.test_frame import DOCUMENTED_PREPROCESSOR

    count_cpu_copies(monkeypatch.setattr)
    devcache.reset_global_devcache()
    stores, apps = _titanic_apps(tmp_path)
    client = apps["port"].test_client()

    def totals():
        return profile.flow_totals()["h2d_bytes"], base.h2d_bytes()

    before = totals()
    response = client.post("/models", json={
        "training_filename": "titanic_train", "test_filename": "titanic_test",
        "preprocessor_code": DOCUMENTED_PREPROCESSOR, "classificators_list": FIVE,
    })
    assert response.status_code == 201
    _warmups_settled(client, len(FIVE))   # the publish-time warmups copy their rows too
    after = totals()
    assert after[0] - before[0] == after[1] - before[1] > 0
    checkpoint = str(tmp_path / "port" / "titanic_test_prediction_dt.model")

    def request(out):
        builder.predict_with_model(stores["port"], checkpoint, "titanic_train", "titanic_test",
                                   DOCUMENTED_PREPROCESSOR, out, device="cpu")

    request("batch_1")
    warm = totals()
    assert warm[0] - after[0] == warm[1] - after[1]
    request("batch_2")
    assert totals() == warm
    devcache.reset_global_devcache()


def test_d2h_counter_counts_every_copy_of_a_build(tmp_path, monkeypatch):
    """Over a CPU build (the CPU's copies counted, as on a card), the
    flight recorder's ``lo_d2h_bytes_total`` moves by the bytes of every
    ``Tensor.cpu()`` the build made: predictions, metrics, the fitted
    parameters its checkpoints gather, the fits' one-value reads."""
    import torch

    from tests.test_frame import DOCUMENTED_PREPROCESSOR

    copied = []
    cpu = torch.Tensor.cpu

    def counted_cpu(tensor, *args, **kwargs):
        copied.append(tensor.numel() * tensor.element_size())
        return cpu(tensor, *args, **kwargs)

    count_cpu_copies(monkeypatch.setattr)
    monkeypatch.setenv("LO_BUILD_WORKERS", "1")
    _, apps = _titanic_apps(tmp_path)
    client = apps["port"].test_client()
    before = profile.flow_totals()["d2h_bytes"]
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    response = client.post("/models", json={
        "training_filename": "titanic_train", "test_filename": "titanic_test",
        "preprocessor_code": DOCUMENTED_PREPROCESSOR, "classificators_list": FIVE,
    })
    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    assert response.status_code == 201
    assert profile.flow_totals()["d2h_bytes"] - before == sum(copied) > 0


def test_a_launch_shows_on_metrics():
    """A kernel's launch count feeds ``lo_kernel_launches_total{kernel}``
    on its process's ``/metrics``, the family declared at the first
    launch (the CPU launches none, so the test counts one by hand)."""
    from learningorchestra_tpu_torch import kernels
    from learningorchestra_tpu_torch.telemetry.metrics import global_registry

    registry, counts = global_registry(), kernels.launches()
    assert "lo_kernel_launches_total" not in registry.declared_families()
    try:
        kernels.count_launch("route")
        kernels.count_launch("route")
        kernels.count_launch("leaf_sums")
        text = registry.render()
        assert 'lo_kernel_launches_total{kernel="route"} 2' in text
        assert 'lo_kernel_launches_total{kernel="leaf_sums"} 1' in text
        assert kernels.launches()["route"] == counts["route"] + 2
    finally:
        registry._metrics.pop("lo_kernel_launches_total", None)
        kernels._launch_samples.clear()
        kernels._launches.update(counts)


def test_span_attribution_reaches_the_active_span():
    """Each accounting call counts into its family and stamps the active
    span, as the reference's."""
    trace = tracing.Trace("cid_attribution")
    before = profile.flow_totals()
    with tracing.activate(trace), tracing.span("d2h:predictions"):
        profile.account_d2h(64)
        profile.account_h2d(32)
        profile.account_wire("read", "c", 16)
    after = profile.flow_totals()
    assert after["d2h_bytes"] - before["d2h_bytes"] == 64
    assert after["h2d_bytes"] - before["h2d_bytes"] == 32
    assert after["wire_read_bytes"] - before["wire_read_bytes"] == 16
    (span,) = trace.as_dict()["spans"]
    assert span["meta"] == {"d2h_bytes": 64, "h2d_bytes": 32, "wire_bytes": 16}
    jax_trace = jax_tracing.Trace("cid_attribution")
    with jax_tracing.activate(jax_trace), jax_tracing.span("d2h:predictions"):
        jax_profile.account_d2h(64)
        jax_profile.account_h2d(32)
        jax_profile.account_wire("read", "c", 16)
    assert jax_trace.as_dict()["spans"][0]["meta"] == span["meta"]
