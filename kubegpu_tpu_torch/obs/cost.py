"""Chip-tick cost attribution (counterpart of ``kubegpu_tpu/obs/cost.py``,
copied: it is pure Python).

:class:`CostLedger` is the host-side ledger: every engine tick that
dispatches work charges its busy chip-ticks to the resident slots'
``(tenant, tier)`` keys, pro-rata by work units (prefill tokens for
prefilling slots, one unit per decoding slot).  Apportionment is
largest-remainder over integers, so the ledger obeys an exact conservation
law by construction::

    sum(by_key.values()) == busy_chip_ticks        (integer equality)

One CHIP-TICK is one accelerator busy for one engine tick: a ``tp=4``
engine dispatching a fused ``k=8`` block charges ``32``.  Charges are a
pure function of the engine schedule, never of wall clock.
"""
from __future__ import annotations

__all__ = ["CostLedger", "cost_key", "safe_suffix"]


def cost_key(tenant: str, tier: int) -> str:
    """The ledger's string key for one (tenant, tier) bucket —
    ``"acme:t0"`` — used in reports and as a gauge suffix after
    :func:`safe_suffix` sanitization."""
    return f"{tenant or 'anon'}:t{int(tier)}"


def safe_suffix(key: str) -> str:
    """Metric-name-safe form of a ledger key (``acme:t0`` →
    ``acme_t0``)."""
    return "".join(c if c.isalnum() or c == "_" else "_" for c in key)


class CostLedger:
    """Integer chip-tick ledger for ONE engine (merge pool-wide with
    :meth:`merge`).  ``charge`` apportions one tick's chip-ticks over
    the resident (tenant, tier, work_units) entries by largest
    remainder; ties break on the key so attribution is deterministic
    for a fixed slot ordering."""

    __slots__ = ("by_key", "busy_chip_ticks")

    def __init__(self) -> None:
        self.by_key: dict[str, int] = {}    # cost_key → chip-ticks
        self.busy_chip_ticks = 0

    def charge(self, entries, chip_ticks: int) -> None:
        """Attribute ``chip_ticks`` to ``entries`` =
        ``[(tenant, tier, work_units), ...]``.  Zero total work
        degrades to equal shares (a tick that dispatched with resident
        slots is never free); empty entries charge nothing (the engine
        was idle, so there is nothing to conserve)."""
        chip_ticks = int(chip_ticks)
        rows = [(cost_key(t, k), max(0, int(u))) for t, k, u in entries]
        if not rows or chip_ticks <= 0:
            return
        self.busy_chip_ticks += chip_ticks
        total = sum(u for _, u in rows)
        if total <= 0:
            rows = [(key, 1) for key, _ in rows]
            total = len(rows)
        # largest-remainder apportionment: floor shares first, then
        # hand the (< len(rows)) leftover ticks to the largest
        # remainders, ties broken by key then position — the sum of
        # shares equals chip_ticks EXACTLY, which is the whole point
        shares = []
        for pos, (key, u) in enumerate(rows):
            base, rem = divmod(chip_ticks * u, total)
            shares.append([key, base, rem, pos])
        leftover = chip_ticks - sum(s[1] for s in shares)
        for s in sorted(shares, key=lambda s: (-s[2], s[0], s[3]))[:leftover]:
            s[1] += 1
        for key, amt, _, _ in shares:
            if amt:
                self.by_key[key] = self.by_key.get(key, 0) + amt

    def merge(self, other: "CostLedger") -> "CostLedger":
        self.busy_chip_ticks += other.busy_chip_ticks
        for key, v in other.by_key.items():
            self.by_key[key] = self.by_key.get(key, 0) + v
        return self

    @property
    def conserved(self) -> bool:
        """The invariant the bench gates on: every charged chip-tick
        is attributed exactly once."""
        return sum(self.by_key.values()) == self.busy_chip_ticks

    def as_dict(self) -> dict[str, int]:
        return dict(sorted(self.by_key.items()))

    def publish(self, metrics) -> None:
        """Export as ``serve_chip_ticks_total`` (grand total) plus one
        suffixed gauge per (tenant, tier) key."""
        if metrics is None:
            return
        metrics.set_gauge("serve_chip_ticks_total",
                          float(self.busy_chip_ticks))
        for key, v in sorted(self.by_key.items()):
            metrics.set_gauge("serve_chip_ticks_total"
                              + "_" + safe_suffix(key), float(v))
