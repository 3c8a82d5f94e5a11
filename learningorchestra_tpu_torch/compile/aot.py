"""The boot-time pass: build the kernel libraries before a request needs
them, and share them over the store.

Counterpart of ``learningorchestra_tpu/compile/aot.py``
(``backend_fingerprint`` ``:78``, the plane ``:182-303``,
``boot_compile_plane`` ``:305``). A process that first launches a
kernel runs ``nvcc`` on its library's source (``kernels.build``):
seconds to minutes (``logistic.cu`` alone takes about a minute), inside
the first request that needs it, and again on every machine whose build
folder is empty. The pass takes that off the request path: at boot it
fetches the libraries other members published
(``compile/fleetcache.py``), then on a daemon thread builds each
library of the manifest (``compile/manifest.py``) that is not there yet,
and publishes what it holds. Building is host work (nvcc), so the
thread never takes a device-class scheduler slot. Each build is booked
under ``telemetry.profile.compile_source``: ``aot``, or ``fleetcache``
after a fetch that brought libraries in (a warm pass whose builds are
hits), so ``lo_compile_events_total`` separates boot builds from
request-path ones (``jit``).

A library is trusted only under the exact envelope that built it
(:func:`backend_fingerprint`: nvcc's release, torch and its CUDA, the
card and its compute capability, the nvcc flags, and each source's
digest); the fleet cache discards a library of another envelope without
decoding it.

The reference's ``serialize_compiled`` and ``deserialize_compiled`` have
no counterpart here: the built ``.so`` file is itself the artifact that
moves, byte for byte, and ``kernels.library`` loads it as a library
built here. Nor has its ``persist_all_compiles``: every library built
lands in the build folder.
"""

from __future__ import annotations

import functools
import json
import subprocess
import threading
import time
from typing import Callable, Optional

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.compile import config as compile_config
from learningorchestra_tpu_torch.compile.manifest import ProgramSpec, enumerate_programs

_METRICS = None
_METRICS_LOCK = threading.Lock()


def _aot_metrics() -> dict:
    global _METRICS
    with _METRICS_LOCK:
        if _METRICS is None:
            from learningorchestra_tpu_torch.telemetry.metrics import global_registry

            registry = global_registry()
            _METRICS = {
                "compiled": registry.counter(
                    "lo_aot_programs_compiled_total",
                    "Manifest programs compiled by the AOT pass",
                ),
                "published": registry.counter(
                    "lo_aot_programs_published_total",
                    "Executable artifacts published to the fleet cache",
                ),
                "fetched": registry.counter(
                    "lo_aot_programs_fetched_total",
                    "Executable artifacts pulled from the fleet cache",
                ),
                "discarded": registry.counter(
                    "lo_aot_programs_discarded_total",
                    "Fleet artifacts dropped (version-fingerprint "
                    "mismatch or corrupt payload) and recompiled",
                ),
            }
        return _METRICS


@functools.lru_cache(maxsize=None)
def _nvcc_release(nvcc: str) -> Optional[str]:
    """The ``release`` line of ``nvcc --version`` (None: it did not run)."""
    try:
        result = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [line.strip() for line in result.stdout.splitlines() if "release" in line]
    return lines[0] if lines else None


def backend_fingerprint() -> dict:
    """The envelope a built library is only valid under: nvcc's release
    line (None where there is no nvcc), ``torch.__version__`` and
    ``torch.version.cuda``, the card's name and compute capability (None
    in a process that sees no card), ``kernels.NVCC_FLAGS`` and each
    library's source digest (the one its file name carries). Any
    difference means "build it here", never "load it and hope"."""
    import torch

    try:
        nvcc = kernels._find_nvcc()
    except RuntimeError:
        nvcc = None
    card = capability = None
    if torch.cuda.is_available():
        index = torch.cuda.current_device()
        card = torch.cuda.get_device_name(index)
        capability = "%d.%d" % torch.cuda.get_device_capability(index)
    return {
        "nvcc": _nvcc_release(nvcc) if nvcc else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "card": card,
        "capability": capability,
        "nvcc_flags": list(kernels.NVCC_FLAGS),
        "sources": {name: kernels.source_digest(name) for name in kernels.SOURCES},
    }


def compile_spec(spec: ProgramSpec, source: str = "aot") -> str:
    """Build (or find built) one manifest entry, booked under ``source``
    with its library's name as the key; returns the library's path, or
    raises what the build raised (the pass logs it and goes on)."""
    from learningorchestra_tpu_torch.telemetry.profile import compile_source

    with compile_source(source, spec.key):
        path = kernels.build(spec.library, account=True)
    _aot_metrics()["compiled"].inc()
    return path


class AotPlane:
    """The boot-time pass, run synchronously (tests, scripts) or on a
    daemon thread (the runner).

    One pass: fetch the fleet's libraries into the build folder (once:
    :meth:`fetch`, which the runner calls at boot before it serves) →
    enumerate the manifest (the libraries the checkpoints in
    ``models_dir`` need first) → build everything under the cap (the
    dropped entries LOGGED) → publish what the build folder holds.
    ``before_fetch`` (a worker rank's wait for rank 0's publication) runs
    on the pass's thread before its fetch; ``after_run`` gets the stats
    when the pass ends, however it ends."""

    def __init__(
        self,
        store=None,
        models_dir: str = "",
        cache_dir: Optional[str] = None,
        max_programs: Optional[int] = None,
        publish: Optional[bool] = None,
        before_fetch: Optional[Callable[[], None]] = None,
        after_run: Optional[Callable[[dict], None]] = None,
    ):
        self.store = store
        self.models_dir = models_dir
        self.cache_dir = cache_dir
        self.max_programs = compile_config.max_programs() if max_programs is None else max_programs
        self.publish = compile_config.publish_enabled() if publish is None else publish
        self.before_fetch = before_fetch
        self.after_run = after_run
        self._stats: dict = {"state": "idle"}
        self._fetch_stats: Optional[dict] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def _cache_dir(self) -> Optional[str]:
        return self.cache_dir or kernels.build_dir()

    def fetch(self) -> dict:
        """Pull the libraries the fleet published that the build folder
        lacks (nothing without a store or a shared build folder)."""
        from learningorchestra_tpu_torch.compile import fleetcache

        cache_dir = self._cache_dir()
        stats = {"fetched": 0, "discarded": 0, "skipped": 0, "seconds": 0.0}
        if self.store is not None and cache_dir:
            started = time.perf_counter()
            stats.update(fleetcache.fetch(self.store, cache_dir))
            stats["seconds"] = time.perf_counter() - started
        self._fetch_stats = stats
        return stats

    def run(self) -> dict:
        """The synchronous pass; returns (and keeps, for :meth:`stats`)
        its stats."""
        from learningorchestra_tpu_torch.compile import fleetcache
        from learningorchestra_tpu_torch.telemetry.profile import compile_events

        started = time.perf_counter()
        stats: dict = {
            "state": "running", "compiled": 0, "failed": 0, "fetched": 0,
            "discarded": 0, "published": 0, "dropped": 0,
        }
        # published once: stats() snapshots this dict under the lock, so
        # progress shows live and no reader races a second assignment
        with self._lock:
            self._stats = stats
        try:
            if self.before_fetch is not None:
                self.before_fetch()
            fetched = self._fetch_stats if self._fetch_stats is not None else self.fetch()
            stats["fetched"], stats["discarded"] = fetched["fetched"], fetched["discarded"]
            stats["fetch_seconds"] = fetched["seconds"]
            # a warm pass over fetched libraries: the fleet paid for them,
            # not this process's nvcc
            source = "fleetcache" if fetched["fetched"] else "aot"
            kept, dropped = enumerate_programs(self.models_dir, self.max_programs)
            stats["dropped"] = len(dropped)
            if dropped:
                # no silent caps: name what the cap left out
                print(
                    f"[aot] LO_AOT_MAX_PROGRAMS={self.max_programs} dropped {len(dropped)} "
                    "programs: " + ", ".join(spec.key for spec in dropped),
                    flush=True,
                )
            for spec in kept:
                try:
                    compile_spec(spec, source=source)
                    stats["compiled"] += 1
                except Exception as error:  # noqa: BLE001 — the pass is advisory
                    stats["failed"] += 1
                    print(f"[aot] {spec.key} failed: {error}", flush=True)
            cache_dir = self._cache_dir()
            if self.store is not None and cache_dir and self.publish:
                stats["published"] = fleetcache.publish(self.store, cache_dir)["published"]
            stats["events"] = compile_events()
            stats["seconds"] = time.perf_counter() - started
            stats["state"] = "done"
        except BaseException:
            stats["state"] = "failed"
            raise
        finally:
            if self.after_run is not None:
                self.after_run(stats)
        print(f"[aot] pass done: {json.dumps(stats)}", flush=True)
        return stats

    def start(self) -> "AotPlane":
        """Run the pass on a daemon thread: boot goes on at once, and the
        thread never holds a device-class slot."""
        thread = threading.Thread(target=self.run, name="lo-aot-precompile", daemon=True)
        self._thread = thread
        thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)


def boot_compile_plane(
    store=None,
    models_dir: str = "",
    cache_dir: Optional[str] = None,
    before_fetch: Optional[Callable[[], None]] = None,
    after_run: Optional[Callable[[dict], None]] = None,
) -> Optional[AotPlane]:
    """The runner's boot hook: when ``LO_AOT=1``, fetch the fleet's
    libraries now (before the first request can need one), then start
    the pass on its thread; else do nothing (the knob is validated
    either way). With ``before_fetch`` the fetch waits for it on the
    pass's thread instead."""
    if not compile_config.aot_enabled():
        return None
    plane = AotPlane(
        store=store, models_dir=models_dir, cache_dir=cache_dir,
        before_fetch=before_fetch, after_run=after_run,
    )
    if before_fetch is None:
        fetched = plane.fetch()
        print(f"[aot] fleet fetch at boot: {json.dumps(fetched)}", flush=True)
    return plane.start()
