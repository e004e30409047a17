"""Chunk re-assignment: the plan side of out-of-core staging across hosts.

Port of the reference's `data/planner.py`, host logic in one process.
`ChunkPlanner` owns a deterministic chunk->host assignment (round-robin
over the sorted host list); `reassign()` drains every PENDING chunk off
flagged hosts onto the healthy ones, and `remove_hosts()` drops dead hosts
for good. Re-assignment never touches model math: `ChunkStager` writes each
chunk's binned rows by row range into a shared spill cache, so the output
is identical no matter which host bins which chunk. The seeded
`data.planner.reassign` fault site makes the actuation chaos-testable — an
injected error skips that reassignment round (the plan stays as it is), it
never corrupts the assignment.

The multi-process supervisor drives it
(`reliability.TrainingSupervisor(chunk_planner=...)`): on each beat the
`telemetry.goodput.StragglerDetector`'s flagged processes go to
`reassign`, and `reliability.elastic.HostLeases`' dead ones to
`remove_hosts` (through `ElasticPlan.shrink`). Each process stages its
own `pending` chunks (`data.ChunkStager(only=...)`) into the shared
spill cache. A move is journaled as a `train.chunk.reassign` event to the
`tracer` (`.event(name, **attrs)`) and `ledger` (`.append_event`) given;
the port's tracer is ROADMAP Queue 1 item 23.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..reliability import names as tnames
from ..reliability.faults import FaultInjector, InjectedFault

_REASSIGN_SITE = "data.planner.reassign"


class ChunkPlanner:
    """Deterministic chunk->host plan with straggler-driven drain."""

    def __init__(self, n_chunks: int, hosts: Sequence[int],
                 faults: Optional[FaultInjector] = None, tracer=None,
                 ledger=None):
        self.hosts: List[int] = sorted(set(int(h) for h in hosts))
        if not self.hosts:
            raise ValueError("ChunkPlanner needs at least one host")
        self.n_chunks = int(n_chunks)
        # round-robin over sorted hosts: every host derives the same
        # initial plan with no coordination
        self._owner: Dict[int, int] = {
            i: self.hosts[i % len(self.hosts)] for i in range(self.n_chunks)}
        self._done: set = set()
        self._faults = faults      # None: no fault injection
        self._tracer = tracer
        self._ledger = ledger

    # -- plan queries --------------------------------------------------------
    def owner(self, index: int) -> int:
        return self._owner[int(index)]

    def assigned(self, host: int) -> List[int]:
        """All chunk indices currently assigned to `host` (sorted)."""
        host = int(host)
        return sorted(i for i, h in self._owner.items() if h == host)

    def pending(self, host: int) -> List[int]:
        """Chunks assigned to `host` and not yet staged (sorted)."""
        return [i for i in self.assigned(host) if i not in self._done]

    def mark_done(self, index: int) -> None:
        """Record that chunk `index` has been durably staged (done chunks
        never move — their rows are already in the cache)."""
        self._done.add(int(index))

    # -- actuation -----------------------------------------------------------
    def reassign(self, flagged) -> Dict[int, tuple]:
        """Drain pending chunks off flagged hosts onto healthy ones.

        `flagged` holds dicts with a `process_id` key (the reference's
        `StragglerDetector.check()` rows) or plain host ids. Returns
        {chunk_index: (from_host, to_host)} for the chunks that moved
        (empty when nothing needed to move, every host is flagged, or the
        seeded fault skipped the round)."""
        bad = set()
        for f in flagged:
            pid = f.get("process_id") if isinstance(f, dict) else f
            if pid is not None:
                bad.add(int(pid))
        bad &= set(self.hosts)
        healthy = [h for h in self.hosts if h not in bad]
        if not bad or not healthy:
            return {}
        if self._faults is not None:
            try:
                self._faults.perturb(_REASSIGN_SITE)
            except InjectedFault:
                return {}
        moved: Dict[int, tuple] = {}
        per_host: Dict[int, List[int]] = {}
        k = 0
        for frm in sorted(bad):
            for idx in self.pending(frm):
                to = healthy[k % len(healthy)]
                k += 1
                self._owner[idx] = to
                moved[idx] = (frm, to)
                per_host.setdefault(frm, []).append(idx)
        for frm, idxs in sorted(per_host.items()):
            to_hosts = sorted({moved[i][1] for i in idxs})
            if self._tracer is not None:
                self._tracer.event(tnames.TRAIN_CHUNK_REASSIGN_EVENT,
                                   from_host=frm, to_hosts=to_hosts,
                                   chunks=len(idxs))
            if self._ledger is not None:
                try:
                    self._ledger.append_event(
                        tnames.TRAIN_CHUNK_REASSIGN_EVENT,
                        from_host=frm, to_hosts=to_hosts, chunks=idxs)
                except Exception:  # noqa: BLE001 - journal, not control
                    pass
        return moved

    def remove_hosts(self, dead) -> Dict[int, tuple]:
        """Permanently drop `dead` hosts from the rotation, draining their
        pending chunks onto the survivors first (the same move as
        `reassign`). Unlike a straggler drain the dead hosts leave
        `self.hosts`, so later reassignment rounds never route anything
        back to them. Returns the moved chunks; empty when no listed host
        was in the plan or no survivors would remain (shrinking to an
        empty fleet is not a plan)."""
        bad = set(int(h) for h in dead) & set(self.hosts)
        survivors = [h for h in self.hosts if h not in bad]
        if not bad or not survivors:
            return {}
        moved = self.reassign(sorted(bad))
        self.hosts = survivors
        return moved
