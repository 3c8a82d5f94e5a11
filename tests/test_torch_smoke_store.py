"""chip_smoke.py's ``store`` phase rehearsed on the CPU at a small size.

The phase starts a primary and a follower store server as child
processes (``python -m learningorchestra_tpu_torch.core.store_service``:
sync replication, automatic promotion, peers), runs the seven services
in this process over ``connect("primary,follower")`` with a
shared-memory ring, ingests the product collections and a batch test
collection through the binary verbs, and holds: the sync build's metrics
to an in-process ``InMemoryStore`` build's; a batch request's labels to
the same request's over the ``InMemoryStore``, read over the ring and,
from a ringless client, over the HTTP body; a repeat that probes the
revs over the wire, hits the device cache and copies nothing; a
``set_column_bin`` from another client that moves the rev and makes the
next request reread; then ``kill -9`` of the primary, the follower's
promotion with a loss window of 0, and an async build and a batch
request after it that give the values from before.

Here the stack and the apps run on the CPU, the sizes are cut, the ring
is small, the host-to-device counter counts the CPU's copies, and the
kernel launch counts (which only the card's kernels raise) are stubbed:
on the card the phase fails unless every kernel of the build launched.
"""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch.core import devcache  # noqa: E402
from learningorchestra_tpu_torch.services.model_builder import create_app  # noqa: E402
from tests.test_torch_smoke_batch import Launches  # noqa: E402
from tests.torch_card_copies import count_cpu_copies  # noqa: E402


@pytest.fixture()
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "create_app", lambda store, **kw: create_app(store, device="cpu", **kw))
    monkeypatch.setattr(chip_smoke, "STORE_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "kernels", Launches())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    count_cpu_copies(monkeypatch.setattr)
    for name, value in (
        ("PRODUCT_ROWS", 2_000), ("FIT_ROWS", 4_000), ("STORE_BATCH_ROWS", 3_000),
        ("STORE_SHM_BYTES", 8 * 2**20),
    ):
        monkeypatch.setattr(chip_smoke, name, value)
    devcache.reset_global_devcache()
    yield
    devcache.reset_global_devcache()


def test_store_phase_runs_on_the_cpu(on_the_cpu, capsys):
    record = chip_smoke.phase_store(torch, "cpu rehearsal")
    assert record["build"]["metrics"] == record["local_build"]["metrics"]
    ring, body = record["batch_over_ring"], record["batch_over_body"]
    assert ring["rows"] == body["rows"] == 3_000
    assert ring["shm"]["frames"] > 0 and ring["roads"]["frames"]["ring"] > 0
    assert body["roads"]["frames"]["ring"] == 0 and body["roads"]["bytes"]["body"] > 0
    assert "load_data" in ring["timings"] and "load_data" in body["timings"]
    again = record["batch_again"]
    assert again["rev_probes"] > 0 and again["devcache"]["copied_bytes"] == 0
    assert record["rev"]["after"] != record["rev"]["before"]
    failover = record["failover"]
    assert failover["loss_window"]["records"] == 0 and failover["term"] >= 2
    assert failover["client_now_at"] is True and failover["promote_s"] > 0
    assert failover["async_build"]["metrics"] == record["local_build"]["metrics"]
    assert set(record["launches"]) == set(chip_smoke.BUILD_KERNELS)
    assert '"phase": "store"' in capsys.readouterr().out


def test_store_phase_is_a_phase_of_its_own():
    """``python3 chip_smoke.py store`` runs it: it is among the phases,
    after the batch lane and before the bf16 child."""
    phases = chip_smoke.PHASES
    assert phases.index("batch") < phases.index("store") < phases.index("bf16")
