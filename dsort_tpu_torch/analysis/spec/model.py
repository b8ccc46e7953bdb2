"""Explicit-state model checker for the fleet protocol (``cli spec``).

Counterpart of ``dsort_tpu/analysis/spec/model.py``, with the same public
names, state layout, action grammar, exploration order and fixture
schema, so both checkers reach the same states in the same order and
dump the same fixtures.  The controller's job table, the agent's job and
done stores, and the port's `ControlPolicy` are device-free and
``state_dict()``-serializable, which is what explicit-state exploration
needs.  `FleetModel` closes the loop: a bounded abstract fleet (N agents,
J jobs, a FIFO frame queue per link and direction) whose controller queue
IS a live ``dsort_tpu_torch.serve.policy.ControlPolicy`` (round-tripped
through `state_dict` at every step, so DRR token conservation is checked
against the real accounting code, not a model of it), explored
breadth-first over every enabled interleaving of:

- frame delivery in any order the links allow, bounded frame duplication
  (TCP retry / re-attach races),
- agent death (dropping its in-flight frames) and re-attach (resending
  its held results: the restart contract's duplicate source),
- controller crash + restore from the durable snapshot, with the
  reconcile of ``fleet/controller.py`` (done -> finish, running -> keep,
  unknown -> requeue), and the crash points between persist and ack.

Each step names the handler of ``fleet/controller.py`` or
``fleet/agent.py`` it abstracts.  Every reached state is checked against
the `SPEC_INVARIANTS` catalog (machines.py).  A violating schedule is
shrunk by greedy delta-debugging to a minimal action list and dumped as a
JSON fixture that `replay_schedule` re-executes deterministically; the
fixtures under ``tests/data/spec/`` are such dumps.

``seams`` re-introduce two real bugs of the fleet protocol's history,
behind test-only flags, so the checker is never green by construction
(``tests/test_torch_spec.py`` asserts both are caught):

- ``ack_before_persist``: the result handler sends ``result_ack`` before
  the durable flush (the dropped fsync-before-ack ordering).
- ``nonatomic_reserve``: the agent's duplicate-jid check and reservation
  are two steps instead of one atomic critical section, so duplicate
  submits interleave into a double execution.

Stdlib-only at import time (the analysis layer's contract); `ControlPolicy`
is imported inside `_policy` because ``serve.policy`` uses numpy.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field

from dsort_tpu_torch.analysis.spec.machines import SPEC_INVARIANTS

#: The supported test-only bug seams (see module docstring).
SEAMS = ("ack_before_persist", "nonatomic_reserve")


@dataclass(frozen=True)
class ModelConfig:
    """Bounds for one exploration.  The defaults are the smoke bound:
    big enough to clear 10k distinct states, small enough for seconds."""

    n_agents: int = 2
    n_jobs: int = 3
    outstanding_cap: int = 2
    max_duplications: int = 1
    max_deaths: int = 1
    max_reattaches: int = 1
    max_crashes: int = 1
    max_requeues: int = 3

    def to_dict(self) -> dict:
        return {
            "n_agents": self.n_agents, "n_jobs": self.n_jobs,
            "outstanding_cap": self.outstanding_cap,
            "max_duplications": self.max_duplications,
            "max_deaths": self.max_deaths,
            "max_reattaches": self.max_reattaches,
            "max_crashes": self.max_crashes,
            "max_requeues": self.max_requeues,
        }


@dataclass
class Violation:
    invariant: str
    detail: str
    schedule: list[str]

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail,
                "schedule": list(self.schedule)}


@dataclass
class CheckResult:
    states: int
    transitions: int
    depth: int
    elapsed_s: float
    truncated: bool
    violation: Violation | None = None
    invariants: tuple[str, ...] = field(
        default_factory=lambda: tuple(SPEC_INVARIANTS)
    )

    @property
    def ok(self) -> bool:
        return self.violation is None


def _policy(state_dict=None):
    """A fresh port `ControlPolicy`, optionally restored.  Lazy import:
    serve.policy uses numpy, which the analysis layer must not load at
    module import time (DS601)."""
    from dsort_tpu_torch.serve.policy import ControlPolicy

    p = ControlPolicy(max_queue_depth=64, max_tenant_inflight=16)
    if state_dict is not None:
        p.load_state(json.loads(json.dumps(state_dict)))
    return p


def _drr_tokens(policy_state: dict) -> list[str]:
    """Every queued token inside a ControlPolicy state_dict — the ground
    truth for queue conservation."""
    tokens = []
    drr = policy_state.get("drr", {})
    for _, entries in sorted(dict(drr.get("queues", {})).items()):
        for entry in entries:
            # entry shape: (cost, token) or {"token": ...} — take the
            # token wherever the DRR serialization put it.
            if isinstance(entry, dict):
                tokens.append(str(entry.get("token")))
            elif isinstance(entry, (list, tuple)) and len(entry) >= 2:
                tokens.append(str(entry[1]))
            else:
                tokens.append(str(entry))
    return tokens


class FleetModel:
    """One abstract fleet; states are plain JSON-able dicts."""

    def __init__(self, config: ModelConfig | None = None,
                 seams: tuple[str, ...] = ()):
        bad = set(seams) - set(SEAMS)
        if bad:
            raise ValueError(f"unknown seam(s) {sorted(bad)}; know {SEAMS}")
        self.config = config or ModelConfig()
        self.seams = tuple(seams)

    # -- state ---------------------------------------------------------------

    def initial_state(self) -> dict:
        cfg = self.config
        pol = _policy()
        return {
            "ctl": {
                "jobs": {},          # jid -> {status, agent, readmits}
                "policy": pol.state_dict(),
                "pending_flush": False,   # seam: finish happened, durable stale
                "durable": {"jobs": {}, "policy": pol.state_dict()},
            },
            "agents": {
                f"a{i}": {"alive": True, "jobs": {}, "done": [],
                          "pending": []}
                for i in range(cfg.n_agents)
            },
            # Per-link FIFO queues, one per direction — TCP's per-
            # connection ordering, exactly.  Reordering still arises the
            # ways it really can: across links, across directions, and
            # across link incarnations (death drops the queue, re-attach
            # resends held results).
            "net": {
                "c2a": {f"a{i}": [] for i in range(cfg.n_agents)},
                "a2c": {f"a{i}": [] for i in range(cfg.n_agents)},
            },
            "submitted": [],
            "runs": {},              # "aid/jid" -> count
            "finishes": {},          # jid -> count
            "budget": {"dup": cfg.max_duplications,
                       "deaths": cfg.max_deaths,
                       "reattaches": cfg.max_reattaches,
                       "crashes": cfg.max_crashes},
        }

    @staticmethod
    def canon(state: dict) -> str:
        return json.dumps(state, sort_keys=True, separators=(",", ":"))

    @staticmethod
    def _copy(state: dict) -> dict:
        return json.loads(json.dumps(state))

    # -- invariants ----------------------------------------------------------

    def check_invariants(self, state: dict) -> tuple[str, str] | None:
        """First violated (invariant, detail) or None."""
        ctl = state["ctl"]
        jobs = ctl["jobs"]
        for jid in state["submitted"]:
            if jid not in jobs:
                return ("no_lost_job",
                        f"submitted job {jid} missing from the table")
        for jid, n in state["finishes"].items():
            if n > 1:
                return ("no_double_finish",
                        f"job {jid} finished {n} times")
        for aid, frames in state["net"]["c2a"].items():
            for fr in frames:
                if fr[0] != "result_ack":
                    continue
                jid = fr[1]
                dur = ctl["durable"]["jobs"].get(jid, {})
                if dur.get("status") not in ("done", "failed"):
                    return (
                        "durable_before_ack",
                        f"result_ack for {jid} on the wire to {aid} while "
                        f"durable status is {dur.get('status')!r}",
                    )
        for key, n in state["runs"].items():
            if n > 1:
                return ("no_double_run",
                        f"{key} executed {n} times on one agent")
        cap = self.config.outstanding_cap
        held: dict[str, int] = {}
        for jid, j in jobs.items():
            if j["status"] in ("dispatching", "inflight") and j["agent"]:
                held[j["agent"]] = held.get(j["agent"], 0) + 1
        for aid, n in held.items():
            if n > cap:
                return ("bounded_outstanding",
                        f"agent {aid} holds {n} jobs (cap {cap})")
        # Lazy conservation, exactly the real dispatcher's discipline:
        # every queued job holds exactly one DRR token; a token for a
        # non-queued job is legal ONLY when that job is terminal (a
        # stale token the pop site will discard).
        tokens = _drr_tokens(ctl["policy"])
        for jid, j in jobs.items():
            if j["status"] == "queued" and tokens.count(jid) != 1:
                return ("queue_conservation",
                        f"queued job {jid} holds {tokens.count(jid)} DRR "
                        f"tokens (want exactly 1)")
        for tok in tokens:
            j = jobs.get(tok)
            if j is None:
                return ("queue_conservation",
                        f"DRR token {tok} names no known job")
            if j["status"] in ("dispatching", "inflight"):
                return ("queue_conservation",
                        f"DRR token {tok} for a job already {j['status']}")
        return None

    # -- actions -------------------------------------------------------------

    def enabled_actions(self, state: dict) -> list[str]:
        cfg = self.config
        ctl = state["ctl"]
        acts = []
        n_sub = len(state["submitted"])
        if n_sub < cfg.n_jobs:
            acts.append(f"submit:j{n_sub}")  # in-order: collapses symmetry
        queued = any(
            j["status"] == "queued" for j in ctl["jobs"].values()
        )
        if queued:
            held: dict[str, int] = {}
            for j in ctl["jobs"].values():
                if j["status"] in ("dispatching", "inflight") and j["agent"]:
                    held[j["agent"]] = held.get(j["agent"], 0) + 1
            for aid, ag in state["agents"].items():
                if ag["alive"] and held.get(aid, 0) < cfg.outstanding_cap:
                    acts.append(f"dispatch:{aid}")
        for aid, frames in state["net"]["c2a"].items():
            if frames:  # FIFO: only the head is deliverable
                acts.append(f"deliver_c2a:{aid}:{':'.join(frames[0])}")
        for aid, frames in state["net"]["a2c"].items():
            if frames:
                acts.append(f"deliver_a2c:{aid}:{':'.join(frames[0])}")
        if state["budget"]["dup"] > 0:
            for chan in ("c2a", "a2c"):
                for aid, frames in state["net"][chan].items():
                    if frames:  # retransmit: a fresh copy at the tail
                        acts.append(f"dup:{chan}:{aid}:{':'.join(frames[0])}")
        for jid, j in sorted(ctl["jobs"].items()):
            # The dispatch lane's accept timeout: reroute while the
            # original submit may still be in flight — the real
            # application-level duplicate source.
            if j["status"] == "dispatching":
                acts.append(f"timeout:{j['agent']}:{jid}")
        for aid, ag in state["agents"].items():
            if "nonatomic_reserve" in self.seams:
                for jid in ag["pending"]:
                    acts.append(f"reserve:{aid}:{jid}")
            for jid, st in ag["jobs"].items():
                if st == "running":
                    acts.append(f"run:{aid}:{jid}")
            if ag["alive"] and state["budget"]["deaths"] > 0:
                acts.append(f"die:{aid}")
            if not ag["alive"] and state["budget"]["reattaches"] > 0:
                acts.append(f"reattach:{aid}")
            if not ag["alive"] and any(
                j["status"] in ("dispatching", "inflight")
                and j["agent"] == aid
                for j in ctl["jobs"].values()
            ):
                acts.append(f"detect_death:{aid}")
        if ctl["pending_flush"]:
            acts.append("flush")
        if state["budget"]["crashes"] > 0 and state["submitted"]:
            acts.append("crash")
        return acts

    def apply(self, state: dict, action: str) -> dict | None:
        """The action's successor state, or None when it is not enabled
        in ``state`` (replay of a shrunk schedule hits this)."""
        s = self._copy(state)
        parts = action.split(":")
        kind = parts[0]
        if kind == "submit":
            return self._submit(s, parts[1])
        if kind == "dispatch":
            return self._dispatch(s, parts[1])
        if kind == "deliver_c2a":
            return self._deliver_c2a(s, parts[1], tuple(parts[2:]))
        if kind == "deliver_a2c":
            return self._deliver_a2c(s, parts[1], tuple(parts[2:]))
        if kind == "dup":
            return self._dup(s, parts[1], parts[2], tuple(parts[3:]))
        if kind == "timeout":
            return self._timeout(s, parts[1], parts[2])
        if kind == "reserve":
            return self._reserve(s, parts[1], parts[2])
        if kind == "run":
            return self._run(s, parts[1], parts[2])
        if kind == "die":
            return self._die(s, parts[1])
        if kind == "reattach":
            return self._reattach(s, parts[1])
        if kind == "detect_death":
            return self._detect_death(s, parts[1])
        if kind == "flush":
            return self._flush(s)
        if kind == "crash":
            return self._crash(s)
        raise ValueError(f"unknown action {action!r}")

    # -- controller-side steps ----------------------------------------------

    def _persist(self, s: dict) -> None:
        """`FleetController._persist_locked` + `_flush_persist`: snapshot
        jobs (dispatching persists as inflight, exactly like
        `_Job.state()`) and the live policy into the durable half."""
        jobs = {}
        for jid, j in s["ctl"]["jobs"].items():
            st = "inflight" if j["status"] == "dispatching" else j["status"]
            jobs[jid] = {"status": st, "agent": j["agent"],
                         "readmits": j["readmits"]}
        s["ctl"]["durable"] = {"jobs": jobs, "policy": s["ctl"]["policy"]}
        s["ctl"]["pending_flush"] = False

    def _submit(self, s: dict, jid: str) -> dict | None:
        if jid in s["ctl"]["jobs"]:
            return None
        pol = _policy(s["ctl"]["policy"])
        verdict = pol.consider("t")
        if not verdict.admitted:
            return None
        pol.push("t", 1, jid)
        s["ctl"]["policy"] = pol.state_dict()
        s["ctl"]["jobs"][jid] = {
            "status": "queued", "agent": None, "readmits": 0,
        }
        s["submitted"].append(jid)
        self._persist(s)
        return s

    def _dispatch(self, s: dict, aid: str) -> dict | None:
        ag = s["agents"].get(aid)
        if ag is None or not ag["alive"]:
            return None
        pol = _policy(s["ctl"]["policy"])
        nxt = pol.pop()
        if nxt is None:
            return None
        _, jid = nxt
        jid = str(jid)
        s["ctl"]["policy"] = pol.state_dict()
        job = s["ctl"]["jobs"].get(jid)
        if job is None or job["status"] != "queued":
            # Stale token (the job finished while requeued): the real
            # dispatcher consumes and discards it (`continue` at the
            # pop site) — lazy conservation, checked as such.
            return s
        job["status"] = "dispatching"
        job["agent"] = aid
        # `_dispatch_loop` routes and persists; `_dispatch_one` flushes
        # that snapshot before the submit frame leaves.
        self._persist(s)
        self._enqueue(s, "c2a", aid, ("submit", jid))
        return s

    def _enqueue(self, s: dict, chan: str, aid: str, frame: tuple) -> None:
        s["net"][chan][aid].append(list(frame))

    def _take(self, s: dict, chan: str, aid: str, frame: tuple) -> bool:
        """Pop the FIFO head iff it matches ``frame`` (replay of a stale
        schedule fails the match and the action reports not-enabled)."""
        q = s["net"][chan][aid]
        if not q or q[0] != list(frame):
            return False
        q.pop(0)
        return True

    def _deliver_a2c(self, s: dict, aid: str, frame: tuple) -> dict | None:
        if not self._take(s, "a2c", aid, frame):
            return None
        kind, jid = frame[0], frame[1]
        job = s["ctl"]["jobs"].get(jid)
        if kind == "accepted":
            # `_dispatch_one`'s accept path: only a still-dispatching job
            # transitions; anything else is late and ignored.
            if job is not None and job["status"] == "dispatching" \
                    and job["agent"] == aid:
                job["status"] = "inflight"
                self._persist(s)
            return s
        if kind == "result":
            if job is None or job["status"] in ("done", "failed"):
                # late duplicate: re-ack, never re-finish (`_on_result`)
                self._enqueue(s, "c2a", aid, ("result_ack", jid))
                return s
            if job["status"] not in ("inflight", "dispatching"):
                # result for a re-queued job (requeue raced the wire):
                # as in `_on_result`, a queued job has not finished
                # elsewhere, so it finishes here (the dispatch that
                # re-queued it finds the done status and stands down).
                pass
            # `_finish_ok`: terminal in memory, policy accounting, persist;
            # `_on_result` acks only once `_flush_persist` has landed it.
            job["status"] = "done"
            job["agent"] = None
            pol = _policy(s["ctl"]["policy"])
            pol.finished("t")
            s["ctl"]["policy"] = pol.state_dict()
            s["finishes"][jid] = s["finishes"].get(jid, 0) + 1
            if "ack_before_persist" in self.seams:
                # THE SEAM: the ack leaves before the durable flush.
                self._enqueue(s, "c2a", aid, ("result_ack", jid))
                s["ctl"]["pending_flush"] = True
            else:
                self._persist(s)
                self._enqueue(s, "c2a", aid, ("result_ack", jid))
            return s
        raise ValueError(f"unexpected a2c frame {frame!r}")

    def _flush(self, s: dict) -> dict | None:
        if not s["ctl"]["pending_flush"]:
            return None
        self._persist(s)
        return s

    def _timeout(self, s: dict, aid: str, jid: str) -> dict | None:
        """`_dispatch_one`'s accept timeout: reroute a dispatching job
        while its submit frame may still be in flight on the old lane —
        the application-level duplicate-submit source the agent's atomic
        reservation exists to survive."""
        job = s["ctl"]["jobs"].get(jid)
        if job is None or job["status"] != "dispatching" \
                or job["agent"] != aid:
            return None
        if job["readmits"] >= self.config.max_requeues:
            job["status"] = "failed"
            job["agent"] = None
            pol = _policy(s["ctl"]["policy"])
            pol.finished("t")
            s["ctl"]["policy"] = pol.state_dict()
            s["finishes"][jid] = s["finishes"].get(jid, 0) + 1
        else:
            job["status"] = "queued"
            job["agent"] = None
            job["readmits"] += 1
            pol = _policy(s["ctl"]["policy"])
            pol.requeue("t", 1, jid)
            s["ctl"]["policy"] = pol.state_dict()
        self._persist(s)
        return s

    def _detect_death(self, s: dict, aid: str) -> dict | None:
        ag = s["agents"].get(aid)
        if ag is None or ag["alive"]:
            return None
        hit = False
        for jid, job in sorted(s["ctl"]["jobs"].items()):
            if job["agent"] == aid and job["status"] in (
                "dispatching", "inflight",
            ):
                if job["readmits"] >= self.config.max_requeues:
                    job["status"] = "failed"
                    job["agent"] = None
                    pol = _policy(s["ctl"]["policy"])
                    pol.finished("t")
                    s["ctl"]["policy"] = pol.state_dict()
                    s["finishes"][jid] = s["finishes"].get(jid, 0) + 1
                else:
                    job["status"] = "queued"
                    job["agent"] = None
                    job["readmits"] += 1
                    pol = _policy(s["ctl"]["policy"])
                    pol.requeue("t", 1, jid)
                    s["ctl"]["policy"] = pol.state_dict()
                hit = True
        if not hit:
            return None
        self._persist(s)
        return s

    def _crash(self, s: dict) -> dict | None:
        if s["budget"]["crashes"] <= 0:
            return None
        s["budget"]["crashes"] -= 1
        # The wire dies with the process; both directions drop.
        for chan in ("c2a", "a2c"):
            for aid in s["net"][chan]:
                s["net"][chan][aid] = []
        # `_load_state`: memory := durable.
        dur = self._copy(s["ctl"]["durable"])
        s["ctl"]["jobs"] = dur["jobs"]
        s["ctl"]["policy"] = dur["policy"]
        s["ctl"]["pending_flush"] = False
        # `_reconcile_restore`: ask every agent about inflight jobs.
        for jid, job in sorted(s["ctl"]["jobs"].items()):
            if job["status"] != "inflight":
                continue
            aid = job["agent"]
            ag = s["agents"].get(aid) if aid else None
            done = [d[0] for d in ag["done"]] if ag else []
            if ag is not None and ag["alive"] and jid in done:
                job["status"] = "done"
                job["agent"] = None
                pol = _policy(s["ctl"]["policy"])
                pol.finished("t")
                s["ctl"]["policy"] = pol.state_dict()
                s["finishes"][jid] = s["finishes"].get(jid, 0) + 1
                self._enqueue(s, "c2a", aid, ("result_ack", jid))
            elif ag is not None and ag["alive"] and jid in ag["jobs"]:
                pass  # still running: stays inflight
            else:
                # unknown to its agent (or the agent is gone): requeue.
                job["status"] = "queued"
                job["agent"] = None
                job["readmits"] += 1
                pol = _policy(s["ctl"]["policy"])
                pol.requeue("t", 1, jid)
                s["ctl"]["policy"] = pol.state_dict()
        self._persist(s)
        return s

    # -- agent-side steps ----------------------------------------------------

    def _deliver_c2a(self, s: dict, aid: str, frame: tuple) -> dict | None:
        if not self._take(s, "c2a", aid, frame):
            return None
        ag = s["agents"][aid]
        if not ag["alive"]:
            return s  # dropped on the floor: the connection is gone
        kind, jid = frame[0], frame[1]
        if kind == "submit":
            done = [d[0] for d in ag["done"]]
            if "nonatomic_reserve" in self.seams:
                # THE SEAM: duplicate check now, reservation later — two
                # deliveries both pass the check before either reserves.
                if jid in ag["jobs"] or jid in done:
                    self._enqueue(s, "a2c", aid, ("accepted", jid))
                    if jid in done:
                        self._enqueue(s, "a2c", aid, ("result", jid))
                    return s
                ag["pending"].append(jid)
                ag["pending"].sort()
                return s
            # `FleetAgent._on_submit`: check AND reserve atomically
            # under the agent's `_lock`.
            if jid in ag["jobs"] or jid in done or jid in ag["pending"]:
                self._enqueue(s, "a2c", aid, ("accepted", jid))
                if jid in done:
                    self._enqueue(s, "a2c", aid, ("result", jid))
                return s
            ag["jobs"][jid] = "running"
            key = f"{aid}/{jid}"
            s["runs"][key] = s["runs"].get(key, 0) + 1
            self._enqueue(s, "a2c", aid, ("accepted", jid))
            return s
        if kind == "result_ack":
            # `_handle`'s result_ack arm drops the held result.
            ag["done"] = [d for d in ag["done"] if d[0] != jid]
            return s
        raise ValueError(f"unexpected c2a frame {frame!r}")

    def _reserve(self, s: dict, aid: str, jid: str) -> dict | None:
        ag = s["agents"][aid]
        if jid not in ag["pending"]:
            return None
        ag["pending"].remove(jid)
        # The seam's point: no re-check against jobs/done here.
        ag["jobs"][jid] = "running"
        key = f"{aid}/{jid}"
        s["runs"][key] = s["runs"].get(key, 0) + 1
        if ag["alive"]:
            self._enqueue(s, "a2c", aid, ("accepted", jid))
        return s

    def _run(self, s: dict, aid: str, jid: str) -> dict | None:
        ag = s["agents"][aid]
        if ag["jobs"].get(jid) != "running":
            return None
        # `_waiter`: `_record_done` moves the job to the done store, then
        # `_push_result` sends it.
        del ag["jobs"][jid]
        ag["done"].append([jid, True])
        ag["done"].sort()
        if ag["alive"]:
            self._enqueue(s, "a2c", aid, ("result", jid))
        # else: the push fails on the dead link; the done store holds the
        # result and the next hello resends it (the restart contract).
        return s

    def _die(self, s: dict, aid: str) -> dict | None:
        """Link death: the agent PROCESS survives (running work keeps
        running, the done store keeps its held results), but both wire
        directions drop their in-flight frames."""
        ag = s["agents"][aid]
        if not ag["alive"] or s["budget"]["deaths"] <= 0:
            return None
        s["budget"]["deaths"] -= 1
        ag["alive"] = False
        s["net"]["c2a"][aid] = []
        s["net"]["a2c"][aid] = []
        return s

    def _reattach(self, s: dict, aid: str) -> dict | None:
        ag = s["agents"][aid]
        if ag["alive"] or s["budget"]["reattaches"] <= 0:
            return None
        s["budget"]["reattaches"] -= 1
        ag["alive"] = True
        # hello/welcome: held results resend (the duplicate source).
        # `_handle`'s hello arm resends those the controller names in
        # ``known_jobs``; resending every held one is a superset of its
        # duplicates, so each schedule of the handler is one of these.
        for jid, _ok in ag["done"]:
            self._enqueue(s, "a2c", aid, ("result", jid))
        return s

    def _dup(self, s: dict, chan: str, aid: str, frame: tuple) -> dict | None:
        q = s["net"][chan][aid]
        if s["budget"]["dup"] <= 0 or not q or q[0] != list(frame):
            return None
        s["budget"]["dup"] -= 1
        self._enqueue(s, chan, aid, frame)
        return s


# -- exploration -------------------------------------------------------------


def check_model(
    config: ModelConfig | None = None,
    seams: tuple[str, ...] = (),
    max_states: int = 200_000,
    max_depth: int = 40,
    stop_on_violation: bool = True,
) -> CheckResult:
    """Breadth-first exploration with canonical-state dedup."""
    model = FleetModel(config, seams)
    t0 = time.monotonic()
    init = model.initial_state()
    init_key = model.canon(init)
    seen = {init_key}
    parents: dict[str, tuple[str | None, str | None]] = {
        init_key: (None, None)
    }
    frontier = deque([(init, 0)])
    transitions = 0
    depth_seen = 0
    truncated = False
    violation = None

    def path_to(key: str) -> list[str]:
        acts = []
        while True:
            parent, act = parents[key]
            if parent is None:
                break
            acts.append(act)
            key = parent
        return list(reversed(acts))

    bad = model.check_invariants(init)
    if bad is not None:
        violation = Violation(bad[0], bad[1], [])
    while frontier and violation is None:
        state, depth = frontier.popleft()
        if depth >= max_depth:
            truncated = True
            continue
        key = model.canon(state)
        for action in model.enabled_actions(state):
            nxt = model.apply(state, action)
            if nxt is None:
                continue
            transitions += 1
            nkey = model.canon(nxt)
            if nkey in seen:
                continue
            seen.add(nkey)
            parents[nkey] = (key, action)
            depth_seen = max(depth_seen, depth + 1)
            bad = model.check_invariants(nxt)
            if bad is not None:
                violation = Violation(bad[0], bad[1], path_to(nkey))
                if stop_on_violation:
                    break
            if len(seen) >= max_states:
                truncated = True
                break
            frontier.append((nxt, depth + 1))
        if truncated and len(seen) >= max_states:
            break
    if violation is not None:
        violation.schedule = minimize_schedule(
            model, violation.schedule, violation.invariant
        )
    return CheckResult(
        states=len(seen), transitions=transitions, depth=depth_seen,
        elapsed_s=round(time.monotonic() - t0, 3), truncated=truncated,
        violation=violation,
    )


def _schedule_violates(model: FleetModel, schedule: list[str],
                       invariant: str) -> bool:
    state = model.initial_state()
    for action in schedule:
        state = model.apply(state, action)
        if state is None:
            return False
        bad = model.check_invariants(state)
        if bad is not None:
            return bad[0] == invariant
    return False


def minimize_schedule(model: FleetModel, schedule: list[str],
                      invariant: str) -> list[str]:
    """Greedy delta-debug: drop any action whose removal still violates
    the same invariant, to a local fixpoint.  Deterministic."""
    sched = list(schedule)
    changed = True
    while changed:
        changed = False
        for i in range(len(sched)):
            cand = sched[:i] + sched[i + 1:]
            if _schedule_violates(model, cand, invariant):
                sched = cand
                changed = True
                break
    return sched


def replay_schedule(
    schedule: list[str],
    config: ModelConfig | None = None,
    seams: tuple[str, ...] = (),
) -> Violation | None:
    """Deterministically re-execute a schedule; the first invariant
    violation (or None).  This is the fixture-replay contract: a dumped
    fixture must reproduce its violation bit-for-bit."""
    model = FleetModel(config, seams)
    state = model.initial_state()
    applied = []
    for action in schedule:
        nxt = model.apply(state, action)
        if nxt is None:
            raise ValueError(
                f"schedule action {action!r} not enabled after {applied}"
            )
        applied.append(action)
        state = nxt
        bad = model.check_invariants(state)
        if bad is not None:
            return Violation(bad[0], bad[1], applied)
    return None


def dump_fixture(path: str, violation: Violation,
                 config: ModelConfig | None = None,
                 seams: tuple[str, ...] = ()) -> None:
    """A violating schedule as a replayable JSON fixture."""
    cfg = config or ModelConfig()
    with open(path, "w", encoding="utf-8") as f:
        json.dump({
            "invariant": violation.invariant,
            "detail": violation.detail,
            "schedule": violation.schedule,
            "seams": list(seams),
            "config": cfg.to_dict(),
        }, f, indent=1)
        f.write("\n")


def load_fixture(path: str) -> tuple[list[str], ModelConfig, tuple[str, ...]]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return (
        list(data["schedule"]),
        ModelConfig(**data.get("config", {})),
        tuple(data.get("seams", ())),
    )


def format_result(result: CheckResult, seams: tuple[str, ...] = ()) -> str:
    lines = [
        f"spec check: {result.states:,} distinct states, "
        f"{result.transitions:,} transitions, depth {result.depth}, "
        f"{result.elapsed_s:.2f}s"
        + (" (stopped at first violation)" if not result.ok
           else " (bound reached)" if result.truncated else " (exhausted)")
        + (f" [seams: {', '.join(seams)}]" if seams else ""),
    ]
    lines.append(
        "invariants: " + ", ".join(SPEC_INVARIANTS)
    )
    if result.ok:
        lines.append("OK — no invariant violated in the explored space")
    else:
        v = result.violation
        lines.append(f"VIOLATION of {v.invariant}: {v.detail}")
        lines.append("minimized schedule:")
        for a in v.schedule:
            lines.append(f"  {a}")
    return "\n".join(lines) + "\n"
