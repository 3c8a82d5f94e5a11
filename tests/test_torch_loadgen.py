"""The JAX package's load-generator tests (``tests/test_loadgen.py``),
run on the port's ``serve/loadgen.py`` and its ``utils/web.py`` servers.

Their source is read and run here with every module path pointed at the
port's, unedited: the closed loop's stats, the sessions closed on every
path out (a failing client, a failing setup that aborts the start
barrier), the targets spread across sessions, a non-200 raised unless
observed, and one reconnect after the server closed a kept-alive
connection (the port's loop closes them on stop).

Below them, the port against the JAX package: the same closed loop over
the same stub sends gives the same stats keys and counts, and both
``http_predict_sender``s spread the same targets the same way.
"""

import pathlib
import re

import pytest

from learningorchestra_tpu.serve import loadgen as jax_loadgen
from learningorchestra_tpu_torch.serve import loadgen as port_loadgen
from learningorchestra_tpu_torch.utils import web as port_web

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_loadgen.py")

_source = REFERENCE_TESTS.read_text()
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    assert run_closed_loop is port_loadgen.run_closed_loop  # noqa: F821
    assert HttpSession is port_loadgen.HttpSession  # noqa: F821
    assert ServerThread is port_web.ServerThread  # noqa: F821
    assert re.findall(r"learningorchestra_tpu\.\w+", _source) == []


@pytest.mark.parametrize("clients,requests,rows", [(1, 3, 1), (3, 5, 4), (8, 2, 64)])
def test_the_closed_loop_is_the_references(clients, requests, rows):
    stats = {}
    for name, module in (("port", port_loadgen), ("jax", jax_loadgen)):
        calls = []
        stats[name] = module.run_closed_loop(calls.append, clients, requests, rows)
        assert sorted(calls) == sorted(i for i in range(clients) for _ in range(requests))
    assert stats["port"].keys() == stats["jax"].keys()
    for key in ("clients", "requests"):
        assert stats["port"][key] == stats["jax"][key] == {"clients": clients, "requests": clients * requests}[key]


def test_the_sender_spreads_targets_as_the_references():
    targets = ["127.0.0.1:5010", "http://127.0.0.1:5011", "localhost:5012"]
    spreads = []
    for module in (port_loadgen, jax_loadgen):
        _, factory = module.http_predict_sender(targets, "m_prediction_lr", [[1.0]])
        sessions = [factory(i) for i in range(7)]
        spreads.append([session.target for session in sessions])
        for session in sessions:
            session.close()
    assert spreads[0] == spreads[1]
