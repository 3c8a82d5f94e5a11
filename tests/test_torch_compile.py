"""The compile plane of the port: the knobs, the manifest, the boot pass
and the fleet cache's trust boundary, on the CPU with a stand-in nvcc.

The JAX package's ``TestConfig``, ``TestFleetCache`` and
``TestPublishHook`` (``tests/test_compile.py:77-114, 263-393, 423-455``)
are read from its test file and run on the port's modules (the same
knobs and parsing; publish and fetch byte-identical, the rev guard,
republication skipped, a mismatched fingerprint or a corrupt chunk set
discarded, a half-published artifact invisible, path traversal refused;
the publish hook). Then the port's own: the library manifest's order,
cap and drop list; the build folder (``LO_JIT_CACHE``); the pass with a
stand-in ``nvcc`` on ``PATH`` that writes known bytes (each kept library
built once, a second pass all hits, compile events by source); the
restart drill over a store server (a runner killed with SIGKILL after
its pass published, a restart on an empty build folder fetches every
library and runs nvcc zero times); and the trust boundary with
``ctypes.CDLL`` made to fail if anything calls it. No library is ever
loaded here: the stand-in's bytes are not one.
"""

import ast
import base64
import ctypes
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import zipfile

import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu_torch import compile as lo_compile  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.compile import aot, fleetcache, manifest  # noqa: E402
from learningorchestra_tpu_torch.compile import config as compile_config  # noqa: E402,F401 (the classes name it)
from learningorchestra_tpu_torch.telemetry import profile  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_compile.py")
PORTED = ("TestConfig", "TestFleetCache", "TestPublishHook", "_write_fake_entries")
LIBRARIES = ("tree_forward", "tree_fit", "logistic", "scaler", "tsne")

# the reference's classes, their source as it is: they name only
# compile_config, fleetcache and lo_compile, bound above to the port's
_tree = ast.parse(REFERENCE_TESTS.read_text())
_nodes = [node for node in _tree.body if getattr(node, "name", None) in PORTED]
assert sorted(node.name for node in _nodes) == sorted(PORTED)
exec(compile(ast.Module(body=_nodes, type_ignores=[]), str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture()
def store():
    from learningorchestra_tpu_torch.core.store import InMemoryStore

    return InMemoryStore()


FAKE_NVCC = textwrap.dedent('''\
    #!{python}
    import os, sys
    args = sys.argv[1:]
    if args == ["--version"]:
        print("nvcc: NVIDIA (R) Cuda compiler driver")
        print("Cuda compilation tools, release 12.4, V12.4.131")
        sys.exit(0)
    with open({log!r}, "a") as log:
        log.write(os.path.basename(args[-1]) + "\\n")
    with open(args[args.index("-o") + 1], "wb") as out:
        out.write(b"stand-in library of " + os.path.basename(args[-1]).encode())
''')


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` first on ``PATH``: ``--version`` prints a
    release line, a build writes known bytes to ``-o`` and logs the
    source's name. Returns the log's path."""
    folder = tmp_path / "fake_bin"
    folder.mkdir()
    log = tmp_path / "nvcc_calls.log"
    nvcc = folder / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{folder}{os.pathsep}{os.environ['PATH']}")
    return log


def _nvcc_calls(log) -> list:
    return log.read_text().splitlines() if log.exists() else []


def _events_since(before: dict) -> dict:
    now = profile.compile_events()
    return {key: now[key] - before.get(key, 0.0) for key in now if now[key] != before.get(key, 0.0)}


def _checkpoint(path, kind: str) -> None:
    with zipfile.ZipFile(path, "w") as archive:
        archive.writestr("__model__.json", json.dumps({"kind": kind, "scalars": {}}))


class TestManifest:
    def test_the_universe_is_the_five_libraries_in_a_fixed_order(self):
        kept, dropped = manifest.enumerate_programs()
        assert [spec.key for spec in kept] == list(LIBRARIES) and dropped == []
        assert set(manifest.libraries()) == set(kernels.SOURCES)

    def test_a_served_tree_model_puts_its_library_first(self, tmp_path):
        _checkpoint(tmp_path / "a_lr.model", "logistic")
        _checkpoint(tmp_path / "b_nb.model", "naive_bayes")
        kept, _ = manifest.enumerate_programs(str(tmp_path))
        assert [spec.key for spec in kept] == list(LIBRARIES)   # lr and nb forwards need none
        _checkpoint(tmp_path / "c_gb.model", "gbt")
        _checkpoint(tmp_path / "d_rf.model", "tree_ensemble")
        (tmp_path / "e_broken.model").write_bytes(b"not a zip")
        (tmp_path / "notes.txt").write_text("not a checkpoint")
        kept, _ = manifest.enumerate_programs(str(tmp_path))
        assert kept[0] == manifest.ProgramSpec("tree_forward")
        assert manifest.specs_for_artifact(str(tmp_path / "c_gb.model")) == [manifest.ProgramSpec("tree_forward")]
        assert [spec.key for spec in kept] == ["tree_forward", "tree_fit", "logistic", "scaler", "tsne"]
        assert manifest.specs_for_artifact(str(tmp_path / "a_lr.model")) == []

    def test_the_cap_returns_the_drop_list(self, tmp_path):
        _checkpoint(tmp_path / "m.model", "tree_ensemble")
        full, _ = manifest.enumerate_programs(str(tmp_path))
        for cap in (0, 2, 5, 64):
            kept, dropped = manifest.enumerate_programs(str(tmp_path), max_programs=cap)
            assert len(kept) == min(cap, 5)
            assert kept + dropped == full   # nothing silently vanishes
        assert manifest.enumerate_programs(str(tmp_path), max_programs=1)[0][0].key == "tree_forward"


class TestBuildFolder:
    def test_unset_is_the_package_folder(self, monkeypatch):
        monkeypatch.delenv("LO_JIT_CACHE", raising=False)
        assert kernels.build_dir() == kernels.BUILD_DIR == os.path.join(
            _ROOT, "learningorchestra_tpu_torch", "kernels", "_build")

    def test_set_is_that_folder(self, tmp_path, monkeypatch):
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "kernels"))
        assert kernels.build_dir() == str(tmp_path / "kernels")
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("LO_JIT_CACHE", "relative")
        assert kernels.build_dir() == str(tmp_path / "relative")

    def test_empty_keeps_nothing(self, tmp_path, monkeypatch, fake_nvcc):
        """``LO_JIT_CACHE=""`` turns the shared folder off, as it turns
        the reference's persistent cache off: a build lands in a folder
        of this process's own, and the pass fetches and publishes
        nothing."""
        monkeypatch.setenv("LO_JIT_CACHE", "")
        assert kernels.build_dir() is None
        path = kernels.build("scaler")
        assert os.path.dirname(path) == kernels._private_dir() != kernels.BUILD_DIR
        assert os.path.basename(path) == kernels.library_file("scaler")
        store = _store()
        stats = aot.AotPlane(store=store, max_programs=1, publish=True).run()
        assert stats["fetched"] == 0 and stats["published"] == 0
        assert list(store.find(fleetcache.COLLECTION, {})) == []


def _store():
    from learningorchestra_tpu_torch.core.store import InMemoryStore

    return InMemoryStore()


class TestPass:
    def test_each_library_built_once_then_hits(self, tmp_path, monkeypatch, fake_nvcc):
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "kernels"))
        before = profile.compile_events()
        first = aot.AotPlane(max_programs=64).run()
        assert first["state"] == "done" and first["compiled"] == 5 and first["failed"] == 0
        assert sorted(_nvcc_calls(fake_nvcc)) == sorted(f"{name}.cu" for name in LIBRARIES)
        assert _events_since(before) == {"miss/aot": 5.0}
        for name in LIBRARIES:
            built = tmp_path / "kernels" / kernels.library_file(name)
            assert built.read_bytes() == f"stand-in library of {name}.cu".encode()
        before = profile.compile_events()
        second = aot.AotPlane().run()
        assert second["compiled"] == 5 and len(_nvcc_calls(fake_nvcc)) == 5   # all hits
        assert _events_since(before) == {"hit/aot": 5.0}
        assert second["events"]["hit/aot"] >= 5

    def test_the_cap_builds_a_prefix_and_logs_the_rest(self, tmp_path, monkeypatch, fake_nvcc, capsys):
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "kernels"))
        stats = aot.AotPlane(max_programs=2).run()
        assert (stats["compiled"], stats["dropped"]) == (2, 3)
        assert _nvcc_calls(fake_nvcc) == ["tree_forward.cu", "tree_fit.cu"]
        assert "LO_AOT_MAX_PROGRAMS=2 dropped 3 programs: logistic, scaler, tsne" in capsys.readouterr().out

    def test_a_failed_build_is_logged_and_the_pass_goes_on(self, tmp_path, monkeypatch, capsys):
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "kernels"))
        monkeypatch.setattr(kernels, "_find_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
        stats = aot.AotPlane(max_programs=2).run()
        assert (stats["compiled"], stats["failed"], stats["state"]) == (0, 2, "done")
        assert "[aot] tree_forward failed: nvcc not found" in capsys.readouterr().out

    def test_publish_then_a_fresh_folder_fetches_and_runs_no_nvcc(self, tmp_path, monkeypatch, fake_nvcc):
        store = _store()
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "first"))
        first = aot.AotPlane(store=store, publish=True).run()
        assert first["published"] == 5 and len(_nvcc_calls(fake_nvcc)) == 5
        metas = list(store.find(fleetcache.COLLECTION, {"meta": 1}))
        assert sorted(meta["artifact"] for meta in metas) == sorted(kernels.library_file(n) for n in LIBRARIES)
        assert {meta["fingerprint"] for meta in metas} == {fleetcache._fingerprint_json()}

        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "fresh"))
        before = profile.compile_events()
        monkeypatch.setenv("LO_AOT", "1")
        booted = lo_compile.boot_compile_plane(store=store)
        booted.join(60)
        stats = booted.stats()
        assert stats["state"] == "done" and stats["fetched"] == 5 and stats["compiled"] == 5
        assert len(_nvcc_calls(fake_nvcc)) == 5   # nvcc ran zero times here
        assert _events_since(before) == {"hit/fleetcache": 5.0}
        for name in LIBRARIES:
            assert (tmp_path / "fresh" / kernels.library_file(name)).read_bytes() == (
                tmp_path / "first" / kernels.library_file(name)).read_bytes()

    def test_boot_is_off_unless_asked(self, monkeypatch):
        monkeypatch.delenv("LO_AOT", raising=False)
        assert lo_compile.boot_compile_plane(store=_store()) is None
        monkeypatch.setenv("LO_AOT", "yes")
        with pytest.raises(ValueError):
            lo_compile.boot_compile_plane(store=_store())

    def test_a_worker_rank_fetches_after_the_wait(self, tmp_path, monkeypatch, fake_nvcc):
        """``before_fetch`` (a rank past 0 waiting for rank 0's pass) runs
        on the pass's thread before the fetch, and ``after_run`` gets the
        stats."""
        store, order = _store(), []
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "rank0"))
        aot.AotPlane(store=store, publish=True, after_run=lambda stats: order.append(("rank 0", stats["published"]))).run()
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "rank1"))
        monkeypatch.setenv("LO_AOT", "1")
        plane = lo_compile.boot_compile_plane(store=store, before_fetch=lambda: order.append(("wait", None)))
        plane.join(60)
        assert order == [("rank 0", 5), ("wait", None)]
        assert plane.stats()["fetched"] == 5 and len(_nvcc_calls(fake_nvcc)) == 5


class TestFingerprint:
    def test_the_envelope(self, fake_nvcc):
        fingerprint = aot.backend_fingerprint()
        assert fingerprint["nvcc"] == "Cuda compilation tools, release 12.4, V12.4.131"
        assert fingerprint["torch"] == torch.__version__ and fingerprint["cuda"] == torch.version.cuda
        assert fingerprint["card"] is None and fingerprint["capability"] is None   # no card here
        assert fingerprint["nvcc_flags"] == list(kernels.NVCC_FLAGS)
        assert fingerprint["sources"] == {
            name: kernels.library_file(name)[len(name) + 1:-3] for name in kernels.SOURCES}


def _refuse(*args, **kwargs):
    raise AssertionError("a library was loaded")


class TestTrustBoundary:
    """A library whose fingerprint or sha256 differs is never decoded,
    written or loaded: ``ctypes.CDLL`` fails if anything calls it."""

    @pytest.fixture(autouse=True)
    def no_loads(self, monkeypatch):
        monkeypatch.setattr(ctypes, "CDLL", _refuse)
        monkeypatch.setattr(kernels.ctypes, "CDLL", _refuse)

    def _published(self, store, tmp_path, monkeypatch, fake_nvcc, fingerprint=None) -> None:
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "publisher"))
        if fingerprint is not None:
            monkeypatch.setattr(fleetcache, "_fingerprint_json", lambda: json.dumps(fingerprint))
        aot.AotPlane(store=store, publish=True).run()
        monkeypatch.undo()
        monkeypatch.setattr(ctypes, "CDLL", _refuse)
        monkeypatch.setattr(kernels.ctypes, "CDLL", _refuse)
        monkeypatch.setenv("PATH", f"{fake_nvcc.parent / 'fake_bin'}{os.pathsep}{os.environ['PATH']}")

    def test_another_envelope_is_discarded_without_decoding(self, tmp_path, monkeypatch, fake_nvcc):
        store = _store()
        self._published(store, tmp_path, monkeypatch, fake_nvcc, {"card": "another card", "nvcc": "release 0"})
        monkeypatch.setattr(fleetcache.base64, "b64decode", _refuse)
        fresh = tmp_path / "fresh"
        stats = fleetcache.fetch(store, str(fresh))
        assert stats == {"fetched": 0, "discarded": 5, "skipped": 0}
        assert os.listdir(fresh) == []
        # the pass builds them here instead, and still loads nothing
        monkeypatch.setenv("LO_JIT_CACHE", str(fresh))
        calls = len(_nvcc_calls(fake_nvcc))
        stats = aot.AotPlane(store=store, publish=False).run()
        assert stats["discarded"] == 0 and stats["compiled"] == 5   # the rev guard: no refetch
        assert len(_nvcc_calls(fake_nvcc)) == calls + 5

    def test_a_corrupt_library_is_never_written(self, tmp_path, monkeypatch, fake_nvcc):
        store = _store()
        self._published(store, tmp_path, monkeypatch, fake_nvcc)
        name = kernels.library_file("tsne")
        chunk = store.find_one(fleetcache.COLLECTION, {"_id": f"{name}#0"})
        forged = base64.b64encode(b"forged" + base64.b64decode(chunk["data"])).decode()
        store.update_one(fleetcache.COLLECTION, {"_id": f"{name}#0"}, {"data": forged})
        fresh = tmp_path / "fresh"
        stats = fleetcache.fetch(store, str(fresh))
        assert (stats["fetched"], stats["discarded"]) == (4, 1)
        assert name not in os.listdir(fresh)
        assert not [entry for entry in os.listdir(fresh) if entry.endswith(".tmp")]

    def test_a_name_that_leaves_the_folder_is_refused(self, tmp_path):
        store, payload = _store(), b"stand-in"
        for evil in (os.path.join("..", "evil.so"), "/tmp/evil.so", "..", "", "half.so.1.fetch.tmp"):
            store.insert_one(fleetcache.COLLECTION, {"artifact": evil, "seq": 0,
                                                     "data": base64.b64encode(payload).decode()})
            store.insert_one(fleetcache.COLLECTION, {
                "artifact": evil, "meta": 1, "chunks": 1, "size": len(payload),
                "sha256": hashlib.sha256(payload).hexdigest(), "fingerprint": fleetcache._fingerprint_json(),
            })
        fresh = tmp_path / "fresh"
        stats = fleetcache.fetch(store, str(fresh))
        assert stats == {"fetched": 0, "discarded": 5, "skipped": 0}
        assert os.listdir(fresh) == [] and not (tmp_path / "evil.so").exists()

    def test_two_publishers_land_one_copy(self, tmp_path, monkeypatch, fake_nvcc):
        """Members publishing one library at once: the second copy is
        refused (the rows' ``_id``), so the collection holds one meta row
        a library."""
        store = _store()
        monkeypatch.setenv("LO_JIT_CACHE", str(tmp_path / "a"))
        aot.AotPlane(max_programs=5).run()
        monkeypatch.setattr(fleetcache, "_published_artifacts", lambda store: set())   # both saw none
        assert fleetcache.publish(store, str(tmp_path / "a"))["published"] == 5
        assert fleetcache.publish(store, str(tmp_path / "a")) == {"published": 0, "skipped": 5}
        assert len(list(store.find(fleetcache.COLLECTION, {"meta": 1}))) == 5


_DRILL_CHILD = textwrap.dedent(
    """
    import json, os, sys

    from learningorchestra_tpu_torch.compile.aot import AotPlane
    from learningorchestra_tpu_torch.core.store_service import RemoteStore
    from learningorchestra_tpu_torch.telemetry.profile import compile_events

    store = RemoteStore(os.environ["DRILL_STORE_URL"])
    stats = AotPlane(store=store, publish=True).run()
    print(json.dumps({"stats": stats, "events": compile_events()}), flush=True)
    if os.environ.get("DRILL_SELF_KILL") == "1":
        os.kill(os.getpid(), 9)   # the crash the fleet cache outlives
    """
)


def _run_drill_child(cache_dir, store_url, self_kill, path_env):
    env = dict(os.environ, LO_JIT_CACHE=cache_dir, DRILL_STORE_URL=store_url,
               DRILL_SELF_KILL="1" if self_kill else "0", PATH=path_env, PYTHONPATH=_ROOT)
    proc = subprocess.run([sys.executable, "-c", _DRILL_CHILD], env=env, capture_output=True, text=True,
                          timeout=240, cwd=_ROOT)
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if not lines:
        raise AssertionError(f"drill child produced no record (rc={proc.returncode}): {proc.stderr[-800:]}")
    return json.loads(lines[-1]), proc.returncode


class TestRestartDrill:
    def test_restarted_runner_runs_no_nvcc(self, tmp_path, fake_nvcc):
        """SIGKILL a runner whose pass built and published the five
        libraries; a restart on an EMPTY build folder fetches every one
        over the store server and runs nvcc zero times, and the files are
        the same bytes."""
        from learningorchestra_tpu_torch.core.store import InMemoryStore
        from learningorchestra_tpu_torch.core.store_service import create_store_app
        from learningorchestra_tpu_torch.utils.web import ServerThread

        store = InMemoryStore()
        server = ServerThread(create_store_app(store), "127.0.0.1", 0).start()
        url = f"http://127.0.0.1:{server.port}"
        first_dir, restart_dir = str(tmp_path / "first"), str(tmp_path / "restart")
        try:
            first, rc = _run_drill_child(first_dir, url, True, os.environ["PATH"])
            assert rc == -9   # it really died
            assert first["stats"]["compiled"] == 5 and first["stats"]["published"] == 5
            assert first["events"] == {"miss/aot": 5.0}
            assert len(_nvcc_calls(fake_nvcc)) == 5

            restarted, rc = _run_drill_child(restart_dir, url, False, os.environ["PATH"])
            assert rc == 0
            assert restarted["stats"]["fetched"] == 5 and restarted["stats"]["published"] == 0
            # THE contract: every library came off the wire, none from nvcc
            assert restarted["events"] == {"hit/fleetcache": 5.0}
            assert len(_nvcc_calls(fake_nvcc)) == 5
            for name in os.listdir(first_dir):
                with open(os.path.join(first_dir, name), "rb") as a, open(os.path.join(restart_dir, name), "rb") as b:
                    assert a.read() == b.read()
        finally:
            server.stop()
