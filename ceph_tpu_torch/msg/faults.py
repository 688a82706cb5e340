"""Deterministic fault injection for the messenger (L3).

The teuthology/msgr-failures analog for this framework: a
``FaultInjector`` installed on a ``Messenger`` intercepts every
outbound and inbound MSG frame and, driven by an explicit
``random.Random(seed)``, applies per-peer-pair rules:

* ``drop``     — discard the frame silently (lossless peers replay it
                 on the next reconnect; lossy clients re-send via the
                 Objecter backoff ramp);
* ``delay``    — hold the frame for a bounded, seeded interval before
                 writing it (out-of-order delivery follows when later
                 frames overtake the held one);
* ``dup``      — write the frame twice (the receiver's seq dedup must
                 absorb it);
* ``reorder``  — hold the frame back and emit it after the NEXT frame
                 on the same connection;
* ``abort``    — kill the transport mid-write (the seeded successor of
                 the legacy ``inject_socket_failures`` knob).

Partitions are separate from probabilistic rules: ``partition(a, b)``
drops EVERY frame between the two entities in both directions until
``heal(a, b)`` — including ACK/CLOSE control frames (``on_control``),
so a cut looks like a dead host even to the session bookkeeping: no
stray ACK can retire unacked lossless entries across a partition, and
no CLOSE can masquerade as an orderly shutdown.  ``isolate(a)`` cuts
``a`` off from everyone.  Entity selectors accept exact names
("mon.1"), type wildcards ("osd.*") and "*".

Every decision consumes the injector's RNG in frame order, so a
failure schedule is replayed exactly by re-running with the same seed
(given the same frame sequence — the deterministic smoke tests in
tests/test_thrash.py pin both).
"""

from __future__ import annotations

import random


def _match(sel: str, entity: str) -> bool:
    if sel == "*" or sel == entity:
        return True
    if sel.endswith(".*"):
        return entity.split(".", 1)[0] == sel[:-2]
    return False


class FaultRule:
    """One probabilistic rule between two entity selectors.  All
    probabilities are per-frame; ``delay``/``delay_max`` bound the
    seeded hold interval in seconds."""

    __slots__ = ("src", "dst", "drop", "dup", "reorder", "abort",
                 "delay_p", "delay", "delay_max")

    def __init__(self, src: str = "*", dst: str = "*",
                 drop: float = 0.0, dup: float = 0.0,
                 reorder: float = 0.0, abort: float = 0.0,
                 delay_p: float = 0.0, delay: float = 0.0,
                 delay_max: float | None = None):
        self.src = src
        self.dst = dst
        self.drop = drop
        self.dup = dup
        self.reorder = reorder
        self.abort = abort
        self.delay_p = delay_p
        self.delay = delay
        self.delay_max = delay if delay_max is None else delay_max

    def matches(self, src: str, dst: str) -> bool:
        return _match(self.src, src) and _match(self.dst, dst)


class FrameAction:
    """The injector's verdict for one frame."""

    __slots__ = ("drop", "dup", "reorder", "abort", "delay")

    def __init__(self):
        self.drop = False
        self.dup = False
        self.reorder = False
        self.abort = False
        self.delay = 0.0

    @property
    def passthrough(self) -> bool:
        return not (self.drop or self.dup or self.reorder
                    or self.abort or self.delay)


_PASS = FrameAction()


class FaultInjector:
    """Seeded fault engine shared by one (or several) messengers.

    Install with ``messenger.fault_injector = FaultInjector(seed)``.
    The messenger consults :meth:`on_send` before writing each MSG
    frame and :meth:`on_recv` after reading one (receive-side checks
    make a single injector enforce BIDIRECTIONAL partitions even when
    the peer's messenger has no injector installed).
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: list[FaultRule] = []
        # frozenset({a, b}) pairs of entity selectors cut off from
        # each other; checked symmetrically
        self.partitions: set[frozenset] = set()
        self.frames_seen = 0
        self.frames_dropped = 0
        self.frames_duplicated = 0
        self.frames_delayed = 0
        self.frames_reordered = 0
        self.aborts = 0

    # -- configuration -----------------------------------------------------

    def add_rule(self, **kw) -> FaultRule:
        rule = FaultRule(**kw)
        self.rules.append(rule)
        return rule

    def clear_rules(self) -> None:
        self.rules = []

    def partition(self, a: str, b: str) -> None:
        """Bidirectional cut between the two selectors (e.g.
        ``partition("mon.1", "*")`` severs mon.1 from everyone)."""
        self.partitions.add(frozenset((a, b)))

    def heal(self, a: str, b: str) -> None:
        self.partitions.discard(frozenset((a, b)))

    def isolate(self, entity: str) -> None:
        self.partition(entity, "*")

    def rejoin(self, entity: str) -> None:
        self.heal(entity, "*")

    def heal_all(self) -> None:
        self.partitions = set()

    def partitioned(self, src: str, dst: str) -> bool:
        for pair in self.partitions:
            sels = tuple(pair)
            if len(sels) == 1:      # self-pair, e.g. {"mon.*"}
                sels = (sels[0], sels[0])
            a, b = sels
            if (_match(a, src) and _match(b, dst)) or \
                    (_match(b, src) and _match(a, dst)):
                return True
        return False

    # -- frame hooks -------------------------------------------------------

    def on_send(self, src: str, dst: str) -> FrameAction:
        """Verdict for an outbound MSG frame src -> dst.  Consumes RNG
        only when a probabilistic rule matches, so unrelated traffic
        does not perturb a pair's schedule."""
        self.frames_seen += 1
        if self.partitioned(src, dst):
            act = FrameAction()
            act.drop = True
            self.frames_dropped += 1
            return act
        act = None
        for rule in self.rules:
            if not rule.matches(src, dst):
                continue
            if act is None:
                act = FrameAction()
            r = self.rng.random()
            if rule.abort and r < rule.abort:
                act.abort = True
                self.aborts += 1
                return act
            if rule.drop and r < rule.drop:
                act.drop = True
                self.frames_dropped += 1
                return act
            if rule.dup and self.rng.random() < rule.dup:
                act.dup = True
                self.frames_duplicated += 1
            if rule.reorder and self.rng.random() < rule.reorder:
                act.reorder = True
                self.frames_reordered += 1
            if rule.delay_p and self.rng.random() < rule.delay_p:
                act.delay = rule.delay + self.rng.random() * max(
                    0.0, rule.delay_max - rule.delay)
                self.frames_delayed += 1
        return act if act is not None else _PASS

    def on_recv(self, src: str, dst: str) -> bool:
        """True = deliver, False = drop.  src is the remote peer, dst
        the local entity.  Only partitions apply on the receive side:
        probabilistic rules fire once, at the sender, so a schedule is
        a single RNG stream."""
        if self.partitioned(src, dst):
            self.frames_dropped += 1
            return False
        return True

    def on_control(self, src: str, dst: str) -> bool:
        """Gate for ACK/CLOSE control frames, both directions.  True =
        deliver.  Only partitions apply — probabilistic rules stay
        MSG-only (control frames carry no payload to lose; a partition
        however must block EVERYTHING, or a stray ACK crossing the cut
        retires unacked lossless entries and a stray CLOSE tears down
        a session whose peer should look dead, not departed)."""
        if self.partitioned(src, dst):
            self.frames_dropped += 1
            return False
        return True

    # -- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        return {
            "seed": self.seed,
            "frames_seen": self.frames_seen,
            "dropped": self.frames_dropped,
            "duplicated": self.frames_duplicated,
            "delayed": self.frames_delayed,
            "reordered": self.frames_reordered,
            "aborts": self.aborts,
        }

    def __repr__(self) -> str:
        return ("FaultInjector(seed=%r, rules=%d, partitions=%d)"
                % (self.seed, len(self.rules), len(self.partitions)))
