"""chip_smoke.py's ``shards`` phase rehearsed on the CPU at a small size.

The phase starts two shard groups, each a primary and a follower store
server as child processes (sync replication, automatic promotion), runs
the seven services in this process over ``connect("p0,f0;p1,f1")``,
writes bench.py's product rows and a larger test file as CSVs and sends
them through ``POST /files`` (natively in slabs: the test file in 5,
each product file in as many as its size gives) and
``PATCH /fieldtypes``, and holds: every collection to the Python parse's
in an in-process ``InMemoryStore``, byte for byte, before and after the
cast; each group's block rows to the placement; one native parse a slab
and no fallback; the shard map; the sync build's metrics and a gb batch
request's labels to the in-process store's; then ``kill -9`` of group
1's primary, its follower's promotion with a loss window of 0, a batch
request after it with the labels from before, and model_builder's
shard gauges for both groups.

Here the apps run on the CPU, the sizes are cut (and the stripe with
them, so that both groups hold rows), the ring is small, and the kernel
launch counts (which only the card's kernels raise) are stubbed: on the
card the phase fails unless every kernel of the build launched.
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
    monkeypatch.setattr(chip_smoke, "SHARDS_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "kernels", Launches())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *args: None)
    count_cpu_copies(monkeypatch.setattr)
    for name, value in (
        ("PRODUCT_ROWS", 2_000), ("FIT_ROWS", 4_000), ("STORE_BATCH_ROWS", 5_000),
        ("STORE_SHM_BYTES", 8 * 2**20), ("SHARDS_STRIPE_ROWS", 256),
    ):
        monkeypatch.setattr(chip_smoke, name, value)
    devcache.reset_global_devcache()
    yield
    devcache.reset_global_devcache()


def test_shards_phase_runs_on_the_cpu(on_the_cpu, capsys):
    one_group = {"batch_over_ring": {"wall_s": 1.0, "timings": {"load_data": 0.5}}}
    record = chip_smoke.phase_shards(torch, "cpu rehearsal", one_group)
    assert record["build"]["metrics"] == record["local_build"]["metrics"]
    assert record["batch"]["rows"] == record["failover"]["batch"]["rows"] == 5_000
    assert "load_data" in record["batch"]["timings"]
    assert record["one_group_batch"] == one_group["batch_over_ring"]
    assert record["slabs"] >= 4 and record["native"]["fallbacks"] == 0
    # product files larger than a slab of the test file, as on the card
    assert record["test_rows"] == 5_000 and record["product_slabs"] >= 2
    assert record["native"]["native_parses"] == record["slabs"] + 1 + 2 * record["product_slabs"]
    for name, held in record["block_rows"].items():
        assert sum(held) == record["rows"][name] and all(rows > 0 for rows in held)
        assert record["block_rows_after_kill"][name] == held
    assert record["shardmap"]["shards"] == 2 and record["shardmap"]["stripe_rows"] == 256
    failover = record["failover"]
    assert failover["loss_window"]["records"] == 0 and failover["term"] >= 2
    assert failover["client_now_at"] is True and failover["promote_s"] > 0
    assert sorted(record["shard_gauges"]) == ["0", "1"]
    assert set(record["ingest_1m_s"]) == {
        "native_slabbed_over_shards", "native_whole_in_process", "python_whole_in_process",
    }
    assert set(record["launches"]) == set(chip_smoke.BUILD_KERNELS)
    assert '"phase": "shards"' in capsys.readouterr().out


def test_a_fallback_fails_the_phase(on_the_cpu, monkeypatch):
    """Where the native loader is unavailable the ingest still lands (the
    Python fallback), but the phase fails: it holds the native path."""
    from learningorchestra_tpu_torch.native import loader

    monkeypatch.setattr(loader, "_get_lib", lambda: None)
    with pytest.raises(AssertionError, match="native parser"):
        chip_smoke.phase_shards(torch, "cpu rehearsal")


def test_shards_phase_is_a_phase_of_its_own():
    """``python3 chip_smoke.py shards`` runs it: it is among the phases,
    right after the store phase, whose one group's batch request it
    stands beside, and before the bf16 child."""
    phases = chip_smoke.PHASES
    assert phases.index("store") + 1 == phases.index("shards") < phases.index("bf16")
