"""Dispatch coalescing for the serving plane.

Copy of ``distributed_gol_tpu/serve/batcher.py`` over the port's
:class:`~distributed_gol_torch.engine.backend.BatchedBackend`.  Resident
sessions whose Params agree on every dispatch-relevant field
(:func:`cohort_key`) form a **launch cohort**, and each superstep the
cohort's members rendezvous at the dispatch seam: one
:class:`~distributed_gol_torch.engine.backend.BatchedBackend` launch
advances every member's board and reduces every member's count (on the
card, one K7 or K8 launch for all of them).

Design constraints, in order:

- **Isolation first.**  Each tenant keeps its own controller, event
  stream, checkpoint dir, and ``DispatchRecorder`` labels — the cohort
  exists only BELOW the dispatch seam, inside
  :class:`_CohortMember.run_turns_async`.  A member that stops showing up
  (faulted and burning its retry budget, wedged, paused, or just slow)
  delays its cohort-mates by at most ``cohort_grace_seconds`` per round;
  once ``cohort_evict_misses`` rounds have fired without it AND it has
  been absent from the seam for that many grace windows, it is EVICTED
  back to a solo launch (``solo=True`` — the inherited
  ``Backend.run_turns_async``; ``_Cohort._evict_stale`` records why both
  gates are needed), so a sick slot can never hold the cohort hostage,
  and a healthy cohort stays bit-identical to solo oracles either way
  (the batched forms are bit-identical per slot by construction).
- **Never a stall.**  Every wait in the rendezvous is bounded: a round
  fires on full membership, at the ``cohort_grace_seconds`` hard cap,
  or — when the optional ``cohort_quiesce_seconds`` early-fire lever
  is armed — once no new member has joined for a quiesce beat; and a
  long fire-guard bounds waiting on another member's in-flight launch
  (the first launch builds the kernels with ``nvcc``).  A member that
  outwaits either simply runs its dispatch solo — correct, just
  unamortised.  A round that fires partial does NOT strand the cohort:
  rounds key on the requested turn count, so latecomers join the next
  open round and the halves re-merge within a superstep.
- **Membership follows the plane.**  Cohorts are (re)computed on admit
  (:meth:`CohortBatcher.member_backend`, the plane's default
  ``backend_factory``), and on park/drain/completion
  (:meth:`CohortBatcher.retire`, from the plane's ``_on_done``).
- **One stream.**  The firing thread launches for every member on its
  current stream (the default stream: nothing here uses a side stream),
  and each member's controller reads its slot and forces its count on
  the same stream.  The batched kernels never write their input, the
  slots handed out are views of one output stack, and the next round
  stacks them into a fresh tensor, so nothing writes a stack a member
  still holds.

Obs: ``serve.batched_launches`` / ``serve.batched_boards`` count fired
rounds and the boards they carried (mean cohort size = boards/launches);
``serve.cohort_evictions`` counts the eviction ladder and
``serve.batched_launch_failures`` the rounds demoted to solo; solo
fallbacks show up as the members' ordinary ``backend.dispatches.*``
bumps — so one snapshot separates physical launches from per-tenant
logical dispatches.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import fields

from distributed_gol_torch.engine.backend import Backend, BatchedBackend
from distributed_gol_torch.engine.params import Params
from distributed_gol_torch.obs import metrics as metrics_lib
from distributed_gol_torch.obs import tracing

#: Params fields that cannot change what or when a session dispatches:
#: identity, filesystem scoping, and the board's INITIAL CONTENT (cohort
#: members differ by soup on purpose).  Every other field is part of the
#: cohort key — conservatively, so two same-shape tenants differing in
#: ANY dispatch-relevant knob (rule, engine, superstep, cadences such as
#: ``sdc_check_every_turns``…) can never silently share a launch.
_KEY_IRRELEVANT = frozenset(
    {"tenant", "out_dir", "images_dir", "soup_density", "soup_seed", "threads"}
)


def cohort_key(params: Params) -> tuple:
    """The launch-cohort grouping key: every dispatch-relevant Params
    field, as a hashable tuple.  Built by EXCLUSION (see
    ``_KEY_IRRELEVANT``) so a future Params field is cohort-splitting by
    default — the safe failure mode is a smaller cohort, never a wrong
    shared launch."""
    return tuple(
        (f.name, getattr(params, f.name))
        for f in fields(Params)
        if f.name not in _KEY_IRRELEVANT
    )


class _Round:
    """One rendezvous: the members who showed up for a dispatch of
    ``turns`` generations before it fired."""

    __slots__ = (
        "turns", "entries", "t0", "last_join", "state", "results", "error",
    )

    def __init__(self, turns: int):
        self.turns = turns
        self.entries: list[tuple[str, object]] = []  # (tenant, board)
        self.t0 = time.monotonic()
        self.last_join = self.t0
        self.state = "open"  # open -> firing -> fired
        self.results: dict[str, tuple] = {}
        self.error: BaseException | None = None


class _Cohort:
    """The members sharing one :func:`cohort_key` and the
    :class:`BatchedBackend` their rounds launch through."""

    def __init__(self, batcher: "CohortBatcher", key: tuple, params: Params):
        self._batcher = batcher
        self.key = key
        self._cond = threading.Condition()
        self.members: dict[str, "_CohortMember"] = {}
        self._rounds: dict[int, _Round] = {}
        self._fired = 0  # rounds fired over the cohort's life
        self.backend = BatchedBackend(params)

    def add(self, member: "_CohortMember") -> None:
        with self._cond:
            member.last_arrival = time.monotonic()
            member.seen_fire = self._fired
            self.members[member.params.tenant] = member

    def remove(self, tenant: str) -> bool:
        """Drop a member (retired/re-admitted elsewhere); waiters
        re-evaluate expected membership.  Returns whether the cohort is
        now empty (the batcher GCs it)."""
        with self._cond:
            self.members.pop(tenant, None)
            self._cond.notify_all()
            return not self.members

    def dispatch(self, member: "_CohortMember", board, turns: int):
        """The rendezvous: join (or open) the round for ``turns``, wait
        for the rest of the cohort up to the grace window, and either
        fire the batched launch on THIS thread or pick up the slot
        result another member's firing produced.  Returns the member's
        (board, count) pair, or None when the member must run solo
        (evicted mid-wait, launch failure, or fire-guard timeout)."""
        tenant = member.params.tenant
        with self._cond:
            if self.members.get(tenant) is not member or member.solo:
                # Retired, evicted, or replaced by a supervisor-rebuild
                # member: this instance dispatches solo (two backends
                # joining one round under one tenant name would collide
                # in the results map).
                return None
            rnd = self._rounds.get(turns)
            if rnd is None or rnd.state != "open":
                rnd = _Round(turns)
                self._rounds[turns] = rnd
            rnd.entries.append((tenant, board))
            rnd.last_join = time.monotonic()
            member.last_arrival = rnd.last_join
            member.seen_fire = self._fired
            if self._batcher.quiesce:
                # Joins reset waiters' quiescence clocks — only armed
                # pods pay the wakeup storm (B waiters × B joins); with
                # quiescence off, waiters need waking only at the fire,
                # and the member completing the membership fires it
                # itself (its own gather loop exits without waiting).
                self._cond.notify_all()
            deadline = rnd.t0 + self._batcher.grace
            # Fire on: full membership (instantly), the optional join-
            # quiescence window (no new arrival for a quiesce beat —
            # the early-fire lever; 0 = off, see ServeConfig), or the
            # grace deadline (hard cap).
            quiesce = self._batcher.quiesce
            while rnd.state == "open" and len(rnd.entries) < len(self.members):
                now = time.monotonic()
                wake = deadline
                if quiesce:
                    wake = min(wake, rnd.last_join + quiesce)
                if now >= wake:
                    break
                self._cond.wait(timeout=wake - now)
            if rnd.state != "open":
                # Another member is firing (or fired) this round; wait it
                # out under the long guard — the first launch may build
                # the kernels with nvcc — then take the slot.
                guard = time.monotonic() + self._batcher.fire_guard_seconds
                while rnd.state != "fired":
                    remaining = guard - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(timeout=remaining):
                        return None  # outwaited the guard: run solo
                if rnd.error is not None:
                    return None
                return rnd.results[tenant]
            # This thread fires the round.
            rnd.state = "firing"
            if self._rounds.get(turns) is rnd:
                del self._rounds[turns]
            entries = list(rnd.entries)
            present = {t for t, _ in entries}
            self._fired += 1
            evicted = self._evict_stale(present)
        for m in evicted:
            self._batcher._c_evicted.inc()
        t0_ns = tracing.clock_ns()
        try:
            outs, counts = self.backend.run_boards(
                [b for _, b in entries], turns
            )
            results = {
                t: (o, c)
                for (t, _), o, c in zip(entries, outs, counts)
            }
            error = None
        except Exception as e:  # noqa: BLE001 — members fall back solo
            results, error = {}, e
        self._record_launch_spans(entries, turns, t0_ns, error)
        with self._cond:
            rnd.results = results
            rnd.error = error
            rnd.state = "fired"
            if error is not None:
                # A failed batched launch demotes the whole round to solo
                # — permanently (the documented ``solo`` contract): a
                # build/trace failure at this arity is deterministic, and
                # without the demotion every later superstep would pay
                # the same doomed batched attempt before each member's
                # solo fallback.  Launch-SUCCEEDED device errors surface
                # at the members' count forces instead and never demote.
                for t, _ in entries:
                    m = self.members.pop(t, None)
                    if m is not None:
                        m.solo = True
            self._cond.notify_all()
        self._batcher._record_round(len(entries), error)
        if error is not None:
            return None
        return results[tenant]

    def _record_launch_spans(self, entries, turns, t0_ns, error) -> None:
        """One batched-launch span per MEMBER trace: every
        member's request timeline shows the shared launch, stamped with
        one ``launch`` id and cross-``links`` to the other members'
        trace ids — how an operator attributes one tenant's latency to a
        cohort-mate's compile or a shared device stall.  Cold-ish path
        (once per fired round); tenants without an active trace cost one
        dict lookup."""
        t1_ns = tracing.clock_ns()
        launch_id = self._batcher._next_launch_id()
        member_traces = [
            (t, tracing.TRACER.for_tenant(t)) for t, _ in entries
        ]
        member_traces = [
            (t, tr) for t, tr in member_traces if tr is not None and not tr.ended
        ]
        ids = [tr.trace_id for _, tr in member_traces]
        for tenant, tr in member_traces:
            tr.record_span(
                "gol.cohort.launch",
                t0_ns,
                t1_ns,
                launch=launch_id,
                boards=len(entries),
                turns=turns,
                error=type(error).__name__ if error is not None else None,
                links=[i for i in ids if i != tr.trace_id],
            )

    def _evict_stale(self, present: set[str]) -> list["_CohortMember"]:
        """Under the lock: the straggler/faulted-slot eviction ladder.
        A member absent from this fired round is evicted back to solo
        launches once BOTH hold: ``cohort_evict_misses`` rounds have
        fired since it last arrived at the dispatch seam, AND it has
        been absent for that many grace windows of wall clock.  The
        round gate means an actively-dispatching member desynced in
        *phase* (a split cohort's other half — its arrivals keep its
        fire watermark fresh) is never evicted; the time gate means a
        burst of partial rounds cannot evict a member that was simply
        descheduled for a beat.  A faulted member (burning its retry
        budget, wedged, parked) fails both and drops out.
        Returns the evicted members (counters bumped outside the
        lock)."""
        n = self._batcher.evict_after
        horizon = time.monotonic() - n * self._batcher.grace
        evicted = []
        for t in list(self.members):
            if t in present:
                continue
            m = self.members[t]
            if self._fired - m.seen_fire >= n and m.last_arrival < horizon:
                del self.members[t]
                m.solo = True
                evicted.append(m)
        return evicted


class _CohortMember(Backend):
    """A tenant's backend inside a launch cohort: the full solo
    :class:`Backend` surface — placement, viewer dispatches, cycle
    probes, and the SDC probes (per-slot fingerprint legs) — with
    ONLY the dispatch seam routed through the cohort rendezvous.
    Evicted members (``solo=True``) run the inherited solo dispatch
    from then on; either path is bit-identical, so eviction is a
    performance decision, never a correctness one."""

    def __init__(self, params: Params, cohort: _Cohort):
        super().__init__(params)
        self._cohort = cohort
        #: Flipped by the eviction ladder (or a failed cohort launch):
        #: this member dispatches solo for the rest of its run.
        self.solo = False
        #: Eviction-ladder watermarks (maintained by the cohort under
        #: its lock): when this member last reached the dispatch seam,
        #: and the cohort's fired-round count at that moment.
        self.last_arrival = 0.0
        self.seen_fire = 0

    def run_turns_async(self, board, turns: int):
        if not self.solo and turns:
            res = self._cohort.dispatch(self, board, turns)
            if res is not None:
                return res
        return super().run_turns_async(board, turns)


class CohortBatcher:
    """The plane-wide coalescer: one :class:`_Cohort` per distinct
    :func:`cohort_key` among resident sessions (``ServeConfig.batched``
    turns it on).  Thread-safe; every method is safe to call from the
    plane's lock-free paths."""

    def __init__(self, config, metrics: bool = True):
        self.grace = config.cohort_grace_seconds
        self.quiesce = config.cohort_quiesce_seconds
        self.evict_after = config.cohort_evict_misses
        #: Bound on waiting for another member's in-flight launch: must
        #: cover the first launch's kernel build, after which the waiter
        #: falls back to a solo dispatch rather than stall its watchdog.
        self.fire_guard_seconds = 300.0
        self._lock = threading.Lock()
        self._cohorts: dict[tuple, _Cohort] = {}
        self._tenant_cohort: dict[str, _Cohort] = {}
        reg = metrics_lib.registry_for(metrics)
        self._c_launches = reg.counter("serve.batched_launches")
        self._c_boards = reg.counter("serve.batched_boards")
        self._c_failed = reg.counter("serve.batched_launch_failures")
        self._c_evicted = reg.counter("serve.cohort_evictions")
        self._g_cohorts = reg.gauge("serve.cohorts")
        self._g_cohorts.set(0)
        # Monotonic batched-launch id: stamped on the
        # ``gol.cohort.launch`` span in every member's request trace, so
        # the traces of one shared launch join on it.
        self._launch_ids = itertools.count(1)

    def _next_launch_id(self) -> int:
        return next(self._launch_ids)

    def member_backend(self, params: Params):
        """Build the backend for one admitted session: a cohort member
        when the Params can cohort (single-device; tenant-stamped), a
        plain solo :class:`Backend` otherwise.  The plane's default
        ``backend_factory`` — also the seam a fault-injection harness
        wraps."""
        if params.tenant is None or params.mesh_shape != (1, 1):
            return Backend(params)
        key = cohort_key(params)
        with self._lock:
            cohort = self._cohorts.get(key)
            if cohort is None:
                cohort = self._cohorts[key] = _Cohort(self, key, params)
            prev = self._tenant_cohort.get(params.tenant)
            # Claim the cohort UNDER the batcher lock, before the (slow)
            # member construction below: the claim is what stops a
            # concurrent retire of the cohort's last member from GC-ing
            # it out of ``_cohorts`` in the window — which would orphan
            # this member and permanently split same-key tenants (the
            # GC predicate checks these claims).
            self._tenant_cohort[params.tenant] = cohort
            self._g_cohorts.set(len(self._cohorts))
        if prev is not None and prev is not cohort and prev.remove(params.tenant):
            self._gc(prev)
        try:
            member = _CohortMember(params, cohort)
        except Exception:
            # Failed build: release the claim so the cohort can GC.
            with self._lock:
                if self._tenant_cohort.get(params.tenant) is cohort:
                    del self._tenant_cohort[params.tenant]
            raise
        cohort.add(member)
        return member

    def retire(self, tenant: str) -> None:
        """A session reached a terminal state (completed, parked,
        drained, failed, shed): leave its cohort so rounds stop waiting
        for it.  Idempotent; unknown tenants are a no-op."""
        with self._lock:
            cohort = self._tenant_cohort.pop(tenant, None)
        if cohort is not None and cohort.remove(tenant):
            self._gc(cohort)

    def _gc(self, cohort: _Cohort) -> None:
        with self._lock:
            if (
                self._cohorts.get(cohort.key) is cohort
                and not cohort.members
                and cohort not in self._tenant_cohort.values()
            ):
                del self._cohorts[cohort.key]
            self._g_cohorts.set(len(self._cohorts))

    def _record_round(self, boards: int, error) -> None:
        if error is not None:
            self._c_failed.inc()
            return
        self._c_launches.inc()
        self._c_boards.inc(boards)

    # -- introspection (tests, health) -----------------------------------------
    @property
    def cohorts(self) -> int:
        with self._lock:
            return len(self._cohorts)

    def cohort_of(self, tenant: str):
        with self._lock:
            return self._tenant_cohort.get(tenant)
