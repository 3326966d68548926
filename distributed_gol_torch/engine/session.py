"""Detach/resume checkpoint state — the broker's control-plane contract.

In the reference, the broker is a separate long-lived process that outlives
controllers: 'q' parks ``{worldSave, turn, size}`` plus a paused flag on it
(``gol/distributor.go:139-147``, ``broker/broker.go:143-148``) and a new
controller resumes via ``Broker.CheckStates`` iff paused ∧ same board size
(``broker/broker.go:124-141``, ``gol/distributor.go:69-91``).

On TPU the broker's *data-plane* job (fan out strips, barrier, concatenate —
``broker/broker.go:37-56,157-180``) disappears into the SPMD program, but
the control-plane contract survives as :class:`Session`: a state holder that
outlives any single :func:`run` call.  In-memory it supports
detach/reattach within a process (the default global session); given a
directory it also persists checkpoints as PGM + sidecar metadata, so a brand
new process can resume — strictly more durable than the reference, whose
checkpoint dies with the broker process.

Durability contract: every persisted
checkpoint is crash-safe AND machine-kill-safe.  The world PGM is written
first, then the sidecar — each atomically (tmp + ``os.replace``) and each
fsync'd, file and directory, so a preemption that kills the machine right
after the replace cannot lose the rename — and the sidecar carries the
world's CRC32, so the
sidecar is the commit record: it never points at a world that is not fully
on disk, and a torn world left by a crash (or a corrupt/truncated sidecar)
is detected at resume, warned about once, and skipped rather than resumed.
Periodic checkpoints (:meth:`save_checkpoint`) rotate under
``checkpoint-<turn>`` stems with keep-last-K pruning, so a torn newest pair
falls back to the previous intact one; the 'q'-detach path keeps the
legacy un-numbered ``checkpoint.*`` stem.
"""

from __future__ import annotations

import json
import threading
import warnings
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from distributed_gol_torch.engine import pgm


@dataclass
class Checkpoint:
    world: np.ndarray  # uint8 {0,255}, shape (h, w)
    turn: int
    # Rule notation ("B3/S23") the checkpointed run used — a framework
    # extension (the reference has exactly one rule, so its CheckStates
    # matches on size alone): resuming a board under a different rule is a
    # different simulation, so a mismatch blocks resume exactly like a
    # size mismatch.  None = unknown (pre-extension checkpoints) matches
    # anything.
    rule: str | None = None
    # Embedded gol-metrics-v1 snapshot of the run that parked this
    # checkpoint: a crashed run's telemetry is readable off its
    # last sidecar.  Never consulted for resume; purely an artifact field.
    metrics: dict | None = None
    # Correlation stamp: the parking run's run_id/tenant,
    # shared with its MetricsReport and flight dumps so sidecar,
    # postmortem, and scrape series join offline.  Artifact-only, never
    # consulted for resume.
    run_id: str | None = None
    tenant: str | None = None
    # Checkpoint truthfulness under time compression: how many
    # generations the parking run actually DISPATCHED (``computed_turns``)
    # vs how many it delivered (``effective_turns`` — equals ``turn``).
    # Only time-compressed runs write them (None stays off the sidecar,
    # keeping default-off runs byte-identical); resume feeds them back to
    # the controller so a resumed run's own sidecars stay cumulative.
    computed_turns: int | None = None
    effective_turns: int | None = None


class Session:
    """Holds pause/quit/checkpoint state across controller attachments.

    Thread-safe (the reference broker's ``paused`` flag is read/written
    unsynchronized across goroutines — quirk Q4; here a lock guards all
    state).
    """

    def __init__(self, checkpoint_dir: str | Path | None = None):
        self._lock = threading.Lock()
        self._paused = False
        self._checkpoint: Checkpoint | None = None
        self._shutdown = False
        self._dir = Path(checkpoint_dir) if checkpoint_dir is not None else None
        # On-disk stem of the current checkpoint pair: "checkpoint" for the
        # 'q'-detach path (legacy name), "checkpoint-<turn>" for rotated
        # periodic saves.
        self._ckpt_name = "checkpoint"
        # Stems THIS session persisted: quit()/discard_checkpoint() remove
        # only these, so a shared directory's foreign pairs stay claimable.
        self._written_stems: set[str] = set()
        self._warned: set[str] = set()  # one warning per bad file per session

    # -- Broker.Pause (broker/broker.go:143-155) ------------------------------
    def pause(
        self,
        paused: bool,
        world: np.ndarray | None = None,
        turn: int = 0,
        rule: str | None = None,
        computed_turns: int | None = None,
        effective_turns: int | None = None,
    ):
        """Set/clear the paused flag; with a world attached this is the 'q'
        checkpoint call (stubs.PauseCall carries World/Turn/Dimension,
        stubs/stubs.go:31-36).  ``rule`` records the rule notation so a
        resume under a different rule is refused (see Checkpoint);
        ``computed_turns``/``effective_turns`` record the parking run's
        time-compression split (see Checkpoint)."""
        with self._lock:
            self._paused = paused
            if paused and world is not None:
                self._checkpoint = Checkpoint(
                    np.asarray(world, dtype=np.uint8), turn, rule,
                    computed_turns=computed_turns,
                    effective_turns=effective_turns,
                )
                self._ckpt_name = "checkpoint"
                self._persist()

    # -- periodic durable checkpoints --------------------------------
    def save_checkpoint(
        self,
        world: np.ndarray,
        turn: int,
        rule: str | None = None,
        keep: int = 3,
        metrics: dict | None = None,
        run_id: str | None = None,
        tenant: str | None = None,
        computed_turns: int | None = None,
        effective_turns: int | None = None,
    ):
        """Park a periodic (crash-recovery) checkpoint: the same resumable
        state a 'q' detach leaves, under a rotated ``checkpoint-<turn>``
        stem so the previous K-1 pairs survive as fallbacks when the
        newest write is torn.  Keeps the newest ``keep`` rotated pairs
        (the controller feeds ``Params.checkpoint_keep`` — the one
        authoritative knob)."""
        with self._lock:
            prev = (self._paused, self._checkpoint, self._ckpt_name)
            self._paused = True
            self._checkpoint = Checkpoint(
                np.asarray(world, dtype=np.uint8), turn, rule, metrics,
                run_id, tenant, computed_turns, effective_turns,
            )
            self._ckpt_name = f"checkpoint-{turn:012d}"
            try:
                self._persist()
                self._rotate(keep)
            except BaseException:
                # A failed persist (ENOSPC, perms) must not leave the
                # session paused on a mid-run board: a COMPLETED run would
                # then look resumable and the next run would silently
                # restart it.  All-or-nothing: roll the slot back, let the
                # caller decide (the controller warns and keeps running).
                self._paused, self._checkpoint, self._ckpt_name = prev
                raise

    def discard_checkpoint(self):
        """Drop the parked checkpoint — the in-memory slot and the ROTATED
        pairs this session wrote — without shutting the session down: the
        run that parked periodic checkpoints completed, so nothing may
        resume from them.  The legacy un-numbered stem (and any rotated
        pair another session wrote into a shared directory) is left
        alone: it may be another controller's still-parked checkpoint
        that this run's check_states refused on a shape/rule mismatch
        (the contract says a mismatch leaves it claimable).  NB the
        in-memory slot is single by design — the reference broker holds
        exactly one checkpoint (``broker/broker.go:143-148``); only the
        on-disk extension is multi-pair."""
        with self._lock:
            self._paused = False
            self._checkpoint = None
            self._unlink_written(rotated_only=True)

    # -- Broker.CheckStates (broker/broker.go:124-141) ------------------------
    def check_states(
        self, width: int, height: int, rule: str | None = None
    ) -> Checkpoint | None:
        """Resume negotiation: returns the checkpoint iff paused ∧ the saved
        world matches (height, width) ∧ the rules agree (both known);
        clears paused as a side effect (the reference broadcasts on its
        pause cond here, ``broker/broker.go:137-138``).  A size or rule
        mismatch leaves the checkpoint parked un-consumed, so a matching
        controller can still claim it.

        Durable sessions scan every on-disk pair, newest turn first, and
        adopt the first INTACT one: a corrupt or truncated sidecar, an
        unreadable world PGM, or a CRC mismatch (torn write) is warned
        about once and skipped — "no checkpoint" rather than an exception
        out of resume negotiation, with older rotated pairs as fallbacks."""
        with self._lock:
            ckpt, paused = self._checkpoint, self._paused
            if ckpt is None and self._dir is not None:
                found = self._adopt_from_disk(width, height, rule)
                if found is None:
                    return None
                ckpt, paused = found, True
            if not paused or ckpt is None:
                return None
            if ckpt.world.shape != (height, width):
                return None
            if rule is not None and ckpt.rule is not None and rule != ckpt.rule:
                return None
            # Adopt + consume: clear paused in memory AND on disk, so the
            # checkpoint is resumed exactly once (a second fresh process must
            # not silently restart from it — nor from an OLDER rotated pair).
            self._checkpoint = ckpt
            self._paused = False
            self._mark_consumed(ckpt.world.shape, ckpt.rule)
            return ckpt

    def _adopt_from_disk(
        self, width: int, height: int, rule: str | None
    ) -> Checkpoint | None:
        """The durable half of resume negotiation: the newest intact pair,
        gated from the few-byte sidecar alone where possible — a mismatch
        has no side effects, so repeated mismatched calls must not re-read
        a multi-GB world PGM each time."""
        for path, meta in self._disk_candidates():
            mrule = meta.get("rule")
            if rule is not None and mrule is not None and rule != mrule:
                # Another controller's pair (the dir may be shared): skip
                # it, leave it parked and claimable — never let it shadow
                # or consume this controller's own checkpoints.
                continue
            mshape = meta.get("shape")
            if mshape is not None and tuple(mshape) != (height, width):
                continue  # same: parked for a different board size
            if not meta.get("paused", False):
                # A consumed record is dead, not a scan stopper: consume
                # marks EVERY matching paused sidecar at adoption time, so
                # any pair still paused now was parked AFTER that consume
                # (a newer run's crash state) and is legitimately
                # adoptable — a stale consumed record from an earlier,
                # higher-turn run must not shadow it.
                continue
            world = self._load_world(path, meta)
            if world is None:
                continue  # torn/unreadable pair: fall back to an older one
            return Checkpoint(
                world,
                int(meta["turn"]),
                mrule,
                computed_turns=meta.get("computed_turns"),
                effective_turns=meta.get("effective_turns"),
            )
        return None

    # -- Broker.Quit (broker/broker.go:182-189) --------------------------------
    def quit(self):
        """'k' teardown: drop all state.  The reference kills the broker and
        worker processes via os.Exit; in-process the analog is discarding the
        checkpoint so nothing can resume.  Scope: this session's own legacy
        pair plus every pair it wrote — a shared directory's foreign pairs
        are another "broker"'s state and stay claimable."""
        with self._lock:
            self._shutdown = True
            self._paused = False
            self._checkpoint = None
            if self._dir is not None:
                # The legacy slot is this session's own even if it never
                # wrote it this process (pre-rotation behaviour).
                (self._dir / "checkpoint.json").unlink(missing_ok=True)
                (self._dir / "checkpoint.pgm").unlink(missing_ok=True)
            self._unlink_written(rotated_only=False)

    @property
    def checkpoint_dir(self) -> Path | None:
        """The durable checkpoint directory (None = in-memory session) —
        where terminal-path flight records land too."""
        return self._dir

    @property
    def paused(self) -> bool:
        with self._lock:
            return self._paused

    @property
    def parked_turn(self) -> int | None:
        """Turn of the in-memory parked checkpoint (None when not
        paused) — how the serving plane's drain receipt reads a
        session's progress when the caller owns the event stream and
        the plane never saw its TurnComplete events."""
        with self._lock:
            if not self._paused or self._checkpoint is None:
                return None
            return self._checkpoint.turn

    @property
    def is_shutdown(self) -> bool:
        with self._lock:
            return self._shutdown

    def reset(self):
        with self._lock:
            self._paused = False
            self._checkpoint = None
            self._shutdown = False

    # -- durable persistence (framework extension) -----------------------------
    @property
    def _world_path(self) -> Path:
        assert self._dir is not None
        return self._dir / f"{self._ckpt_name}.pgm"

    @property
    def _meta_path(self) -> Path:
        assert self._dir is not None
        return self._dir / f"{self._ckpt_name}.json"

    def _persist(self):
        if self._dir is None or self._checkpoint is None:
            return
        self._dir.mkdir(parents=True, exist_ok=True)
        # World BEFORE meta, each atomic (tmp + os.replace): the sidecar is
        # the commit record.  A crash before the meta replace leaves the
        # previous pair (or no pair) authoritative; a torn world under an
        # existing sidecar fails the sidecar's CRC and is skipped at resume.
        # Both writes are DURABLE (fsync file + directory): a preemption that kills the machine right after the
        # replace must not lose the rename, or the emergency-checkpoint
        # guarantee is a lie.
        pgm.write_pgm(self._world_path, self._checkpoint.world, durable=True)
        self._persist_meta(paused=True)
        self._written_stems.add(self._ckpt_name)

    def _persist_meta(self, paused: bool):
        if self._dir is None or self._checkpoint is None:
            return
        self._dir.mkdir(parents=True, exist_ok=True)
        meta = {
            "turn": self._checkpoint.turn,
            "paused": paused,
            "shape": list(self._checkpoint.world.shape),
            # Buffer-protocol CRC: no .tobytes() copy — the world can be
            # hundreds of MB at the headline board sizes.
            "crc32": zlib.crc32(np.ascontiguousarray(self._checkpoint.world)),
        }
        if self._checkpoint.rule is not None:
            meta["rule"] = self._checkpoint.rule
        if self._checkpoint.metrics is not None:
            # The run's telemetry rides the sidecar — ignored by
            # resume negotiation, read by postmortem tooling.
            meta["metrics"] = self._checkpoint.metrics
        if self._checkpoint.run_id is not None:
            # Correlation stamp: same id as the run's
            # MetricsReport and flight dumps; artifact-only.
            meta["run_id"] = self._checkpoint.run_id
        if self._checkpoint.tenant is not None:
            meta["tenant"] = self._checkpoint.tenant
        if self._checkpoint.computed_turns is not None:
            # Checkpoint truthfulness: a time-compressed run's
            # sidecar must distinguish dispatched work from delivered
            # turns.  Consulted at resume (the split stays cumulative),
            # absent on dense runs (byte-identity when the tier is off).
            meta["computed_turns"] = self._checkpoint.computed_turns
        if self._checkpoint.effective_turns is not None:
            meta["effective_turns"] = self._checkpoint.effective_turns
        self._write_json(self._meta_path, meta)

    @staticmethod
    def _write_json(path: Path, meta: dict):
        # Durable like the world write: the sidecar is the COMMIT record,
        # so losing its rename to a machine kill un-commits a checkpoint
        # the caller was told exists.
        pgm.write_bytes_durable(path, json.dumps(meta).encode())

    def _rotate(self, keep: int):
        """Prune THIS session's rotated pairs beyond the newest ``keep``
        (0 = all of them).  Scope matters in a shared directory: foreign
        rotated pairs and the legacy 'q' pair are other controllers'
        claimable state and are never pruned.  Sidecar first — deleting
        the commit record makes the pair dead even if the world unlink is
        lost to a crash."""
        if self._dir is None or keep < 0:
            return
        stems = sorted(
            s for s in self._written_stems if s.startswith("checkpoint-")
        )
        for stem in stems[:-keep] if keep else stems:
            (self._dir / f"{stem}.json").unlink(missing_ok=True)
            (self._dir / f"{stem}.pgm").unlink(missing_ok=True)
            self._written_stems.discard(stem)
        # GC: a CONSUMED rotated pair is dead for everyone (consume-once),
        # whoever wrote it — prune it so crash/resume cycles don't leak a
        # keep-full of multi-hundred-MB worlds per restart.  Paused
        # (claimable) and unreadable (warned-about) foreign pairs stay.
        for path in self._dir.glob("checkpoint-*.json"):
            if path.stem in self._written_stems:
                continue
            meta = self._load_meta(path)
            if meta is not None and not meta.get("paused", True):
                path.unlink(missing_ok=True)
                path.with_suffix(".pgm").unlink(missing_ok=True)

    def _unlink_written(self, rotated_only: bool):
        """Delete the pairs this session persisted (sidecar first — the
        commit record); ``rotated_only`` spares the legacy 'q' stem."""
        if self._dir is None:
            self._written_stems.clear()
            return
        for stem in sorted(self._written_stems):
            if rotated_only and not stem.startswith("checkpoint-"):
                continue
            (self._dir / f"{stem}.json").unlink(missing_ok=True)
            (self._dir / f"{stem}.pgm").unlink(missing_ok=True)
        self._written_stems = (
            {s for s in self._written_stems if not s.startswith("checkpoint-")}
            if rotated_only
            else set()
        )

    def _disk_candidates(self) -> list[tuple[Path, dict]]:
        """(sidecar path, meta) for every readable on-disk sidecar, newest
        turn first.  Unreadable sidecars are warned about once and skipped
        — a corrupt file must degrade to "no checkpoint", never raise out
        of resume negotiation."""
        if self._dir is None or not self._dir.is_dir():
            return []
        out = []
        for path in sorted(self._dir.glob("checkpoint*.json")):
            meta = self._load_meta(path)
            if meta is not None:
                out.append((path, meta))
        out.sort(key=lambda pm: pm[1]["turn"], reverse=True)
        return out

    def _load_meta(self, path: Path | None = None) -> dict | None:
        """Read one checkpoint sidecar (turn/paused/rule/shape/crc32) —
        the world PGM is read only once the cheap gates pass.  Corrupt,
        truncated, or unreadable sidecars return None with a one-time
        warning."""
        path = self._meta_path if path is None else path
        try:
            meta = json.loads(path.read_text())
            if not isinstance(meta, dict) or not isinstance(meta.get("turn"), int):
                raise ValueError("sidecar is not a checkpoint record")
            return meta
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as e:
            self._warn_once(path, f"ignoring unreadable checkpoint sidecar ({e})")
            return None

    def _load_world(self, meta_path: Path, meta: dict) -> np.ndarray | None:
        """The world PGM named by a sidecar, validated against the
        sidecar's CRC32; unreadable or torn worlds return None with a
        one-time warning (pre-CRC sidecars skip the checksum)."""
        world_path = meta_path.with_suffix(".pgm")
        try:
            world = pgm.read_pgm(world_path)
        except (OSError, pgm.PgmError) as e:
            self._warn_once(
                world_path, f"ignoring unreadable checkpoint world ({e})"
            )
            return None
        crc = meta.get("crc32")
        if crc is not None and zlib.crc32(np.ascontiguousarray(world)) != crc:
            self._warn_once(
                world_path, "checkpoint world fails its CRC32 (torn write?)"
            )
            return None
        return world

    def _mark_consumed(self, shape, rule: str | None):
        """Flip THIS controller's on-disk sidecars to paused=False: resume
        is consume-once across the whole rotation (a second fresh process
        must not adopt an older pair of the same run).  Pairs parked for a
        DIFFERENT shape or rule belong to another controller sharing the
        directory and stay claimable; a sidecar with the field missing
        matches anything (it would be adoptable here), so consume-once
        wins and it is flipped."""
        if self._dir is None or not self._dir.is_dir():
            return
        for path in self._dir.glob("checkpoint*.json"):
            meta = self._load_meta(path)
            if meta is None or not meta.get("paused", False):
                continue
            mshape = meta.get("shape")
            if mshape is not None and tuple(mshape) != tuple(shape):
                continue
            mrule = meta.get("rule")
            if rule is not None and mrule is not None and rule != mrule:
                continue
            meta["paused"] = False
            self._write_json(path, meta)

    def _warn_once(self, path: Path, msg: str):
        key = str(path)
        if key in self._warned:
            return
        self._warned.add(key)
        warnings.warn(f"{path}: {msg}", RuntimeWarning, stacklevel=4)


# The default in-process session: the analog of "the one broker at
# 44.193.6.26:8031" (gol/distributor.go:218) every controller dials.
_default_session = Session()


def default_session() -> Session:
    return _default_session
