"""The CPU's copies counted as a card's, for the port's tests on the CPU.

``base._on_card`` decides whether a copy crosses to a card and counts:
``base._account_h2d`` into ``h2d_bytes()`` and ``lo_h2d_bytes_total``,
``base.to_host`` into ``lo_d2h_bytes_total``. On the CPU nothing crosses,
so the rehearsals of chip_smoke's phases and the flight recorder's tests
answer yes for every tensor, and count what a card's run would count.
"""

from learningorchestra_tpu_torch.ml import base


def _every_tensor(tensor) -> bool:
    return True


def count_cpu_copies(setattr=setattr) -> None:
    """Count every copy as a card's; pass ``monkeypatch.setattr`` to undo
    it after a test."""
    setattr(base, "_on_card", _every_tensor)
