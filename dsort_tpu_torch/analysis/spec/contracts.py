"""Journal trace contracts: the declared grammar the drill journals obey.

Counterpart of ``dsort_tpu/analysis/spec/contracts.py``, its own copy
(the port imports nothing of the JAX package).  `TRACE_CONTRACTS` declares
the recovery paths' event sequences once, as a grammar over
`utils.events.EVENT_TYPES` names, literally as the reference declares
them, so a journal of either package is held to the same grammar; the
engine replays any journal against it (``cli report --conform``, the
analyzer's ``conformance`` verdict, and `assert_conformant` in tests).

Grammar: each contract is ``{"scope": (...), "when": (...), "steps":
(...)}``.  ``steps`` joins into one regular expression over event names —
tokens are event names plus ``( ) | ? * +`` — matched against the scoped
trace: records grouped by ``(src, *scope-fields)``, filtered to the
contract's alphabet (the set of names the steps mention), in journal
order.  ``when`` gates applicability: a trace is only checked when it
contains at least one trigger event.  The fleet's ``job_routed`` /
``controller_restore`` contracts trigger on the journals of
`fleet.FleetController`.
"""

from __future__ import annotations

import re

#: The declared trace grammars, the reference's literal.  Names are
#: contract ids surfaced in violations.
TRACE_CONTRACTS = {
    # The whole client-visible life of one job, serve-layer and
    # fleet-controller alike (both stamp every event with the ticket's
    # process-wide ``job`` ordinal): one admission verdict, dequeue/
    # attempt rounds with eviction-readmission or reroute loops between
    # them, at most one terminal, nothing after it.  `job_start` marks
    # "entered a scheduler" and legally repeats per layer: serve stamps
    # one at admission, the execution scheduler another after dequeue.
    "job_lifecycle": {
        "scope": ("job",),
        "when": ("job_admitted", "job_rejected"),
        "steps": (
            "( job_rejected",
            "| job_admitted job_start?",
            "  ( job_dequeued job_start? attempt_start* job_routed?",
            "    ( job_evicted job_readmitted | job_rerouted )? )*",
            "  ( result_fetch* job_done result_fetch* | job_failed )?",
            ")",
        ),
    },
    # The failure-posture ordering: every coded reconstruction is
    # preceded by its trigger — the device death and mesh re-form on the
    # SPMD path, or the eviction-readmission pair on the serve path
    # (serve journals the loss as `job_evicted`, not `worker_dead`).
    # Extra trigger pairs without a reconstruct are the re-run posture
    # and legal in the same journal.  The free-standing alternative is
    # the wave pipeline's inline reconstruct: a coded wave loss
    # never re-forms the mesh or evicts the job — the wave completes
    # from the replica/retained plane and the pipeline moves on.
    "coded_recovery": {
        "scope": (),
        "when": ("coded_recover",),
        "steps": (
            "( worker_dead mesh_reform coded_recover?",
            "| job_evicted job_readmitted coded_recover?",
            "| coded_recover )+",
        ),
    },
    # The parity twin of `coded_recovery`: a parity reconstruction
    # follows the same trigger shapes — device death + mesh re-form on
    # the SPMD path, evict + readmit on the serve path — plus one more:
    # the wave pipeline journals its reconstruct INLINE (the mesh
    # survives a coded wave loss; nothing re-forms and nothing is
    # evicted), so a free-standing `parity_recover` is the third legal
    # shape there.
    "parity_recovery": {
        "scope": (),
        "when": ("parity_recover",),
        "steps": (
            "( worker_dead mesh_reform parity_recover?",
            "| job_evicted job_readmitted parity_recover?",
            "| parity_recover )+",
        ),
    },
    # The straggler-first serve: per (job, range), the exactly-once
    # claim means at most ONE `coded_straggler_serve` ever lands, with
    # the racing owner leg's `coded_owner_fetch` on either side of it
    # (the owner thread finishes before or after the holder — both
    # legal; `won` says who took the claim).  An owner-win race journals
    # only the fetch and is not checked (the `when` gate), matching the
    # no-serve outcome.
    "straggler_serve": {
        "scope": ("job", "range"),
        "when": ("coded_straggler_serve",),
        "steps": (
            "coded_owner_fetch? coded_straggler_serve coded_owner_fetch?",
        ),
    },
    # The restart contract, trace-side: a restarted controller
    # announces `controller_restore` BEFORE it dequeues or routes
    # anything — dispatch from a half-restored table is exactly the bug
    # class the drill exists to catch.
    "controller_restore": {
        "scope": (),
        "when": ("controller_restore",),
        "steps": ("controller_restore ( job_dequeued | job_routed )*",),
    },
    # Wave spans pair up: a `wave_done` never precedes its wave's
    # `wave_start`; a faulted wave may restart (another start) before it
    # completes.  Scoped per (job, wave) — wave ids repeat across jobs.
    "wave_span": {
        "scope": ("job", "wave"),
        "when": ("wave_start",),
        "steps": ("( wave_start wave_done? )+",),
    },
    # Run-granular resume happens while the job is still live: no
    # `wave_resume` after the job's terminal event.
    "wave_resume": {
        "scope": ("job",),
        "when": ("wave_resume",),
        "steps": ("wave_resume+ ( job_done | job_failed )?",),
    },
    # The two-level fault contract: a hier host-grouping re-plan is
    # journaled only as part of a mesh re-form — the device deaths and
    # the survivor count precede it (a hang-reap re-form may carry no
    # worker_dead), never free-standing, at most one per re-form.
    "hier_reform": {
        "scope": (),
        "when": ("hier_reform",),
        "steps": ("( worker_dead* mesh_reform hier_reform? )+",),
    },
}

#: Event types legitimately OUTSIDE any trace contract (telemetry,
#: phase spans, one-shot markers with no ordering obligation), as the
#: reference lists them.
CONTRACT_EXEMPT = (
    "heartbeat_lapse",
    "probe",
    "reassign",
    "capacity_retry",
    "transient_retry",
    "checkpoint_persist",
    "checkpoint_restore",
    "checkpoint_clear",
    "phase_start",
    "phase_end",
    "fused_fallback",
    "worker_join",
    "task_done",
    "device_handle",
    "device_handle_invalidated",
    "device_validate",
    "device_consume",
    "exchange_step",
    "exchange_resize",
    "clock_sync",
    "flight_dump",
    "slice_retired",
    "variant_prewarm",
    "serve_drain",
    "serve_stop",
    "variant_compiled",
    "skew_report",
    "hbm_watermark",
    "fused_exchange_launch",
    "fused_exchange_step",
    "agent_register",
    "agent_heartbeat",
    "health_verdict",
    "agent_degraded",
    "coded_replica_ship",
    "coded_budget_exceeded",
    "plan_decision",
    "plan_override",
    # Hier planning telemetry: per-exchange sizing snapshots with no
    # ordering obligation (the fault-path twin, hier_reform, IS
    # contract-covered above).
    "hier_exchange_plan",
    "hier_exchange_leg",
    # A per-dispatch latency sample (the dispatch_timeout_s policy's
    # measured input): the accept reply and the result race on separate
    # threads, so this marker carries no ordering obligation.
    "job_dispatched",
)

_TOKEN = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|[()|?*+]|\s+")


class ContractError(ValueError):
    """A malformed contract: unknown token, unbalanced grammar."""


def contract_names(contract: dict) -> frozenset[str]:
    """The contract's alphabet: every event name its steps mention."""
    names = set()
    for step in contract["steps"]:
        for tok in _tokens(step):
            if tok not in "()|?*+":
                names.add(tok)
    return frozenset(names)


def _tokens(step: str) -> list[str]:
    out, pos = [], 0
    while pos < len(step):
        m = _TOKEN.match(step, pos)
        if m is None:
            raise ContractError(
                f"bad character {step[pos]!r} in contract step {step!r}"
            )
        pos = m.end()
        tok = m.group()
        if not tok.isspace():
            out.append(tok)
    return out


def compile_contract(contract: dict) -> re.Pattern:
    """Steps -> one regex over ``name,``-encoded traces."""
    parts = []
    for step in contract["steps"]:
        for tok in _tokens(step):
            if tok == "(":
                parts.append("(?:")
            elif tok in ")|?*+":
                parts.append(tok)
            else:
                # Wrap each name with its separator so a postfix ?/*/+
                # binds to the whole token, not the trailing comma.
                parts.append("(?:" + re.escape(tok) + ",)")
    pattern = "".join(parts)
    try:
        return re.compile(pattern)
    except re.error as e:
        raise ContractError(
            f"contract does not compile ({e}): {pattern!r}"
        )


def _as_records(journal) -> list[dict]:
    """Accept an `EventLog`, a list of event objects, or record dicts."""
    events = getattr(journal, "events", None)
    if callable(events):
        journal = events()
    out = []
    for r in journal:
        if isinstance(r, dict):
            out.append(r)
        else:
            out.append(r.to_dict())
    return out


def conformance_report(journal, contracts: dict | None = None) -> dict:
    """Replay a journal against every declared contract.

    Returns ``{"ok": bool, "checked": n_traces, "violations": [...],
    "contracts": {name: {"checked": n, "violations": n}}}``.  A violation
    row names the contract, the scope key of the offending trace, and the
    trace itself — the journal's own evidence.
    """
    contracts = TRACE_CONTRACTS if contracts is None else contracts
    records = _as_records(journal)
    checked_total = 0
    violations = []
    per_contract = {}
    for name, contract in contracts.items():
        alphabet = contract_names(contract)
        pattern = compile_contract(contract)
        when = tuple(contract.get("when", ()))
        scope = tuple(contract.get("scope", ()))
        traces: dict[tuple, list[str]] = {}
        for r in records:
            etype = r.get("type")
            if etype not in alphabet:
                continue
            key = (r.get("src", 0),) + tuple(r.get(f) for f in scope)
            traces.setdefault(key, []).append(etype)
        checked = 0
        bad = 0
        for key, trace in sorted(traces.items(), key=lambda kv: str(kv[0])):
            if when and not any(t in when for t in trace):
                continue
            checked += 1
            if pattern.fullmatch(",".join(trace) + ",") is None:
                bad += 1
                violations.append({
                    "contract": name,
                    "scope": dict(
                        zip(("src",) + scope, key)
                    ),
                    "trace": list(trace),
                })
        per_contract[name] = {"checked": checked, "violations": bad}
        checked_total += checked
    return {
        "ok": not violations,
        "checked": checked_total,
        "violations": violations,
        "contracts": per_contract,
    }


def assert_conformant(journal, contracts: dict | None = None) -> dict:
    """Test helper: raise `AssertionError` naming every violated
    contract; returns the report so callers can add count asserts."""
    report = conformance_report(journal, contracts)
    if not report["ok"]:
        lines = [
            f"{len(report['violations'])} trace-contract violation(s):"
        ]
        for v in report["violations"]:
            lines.append(
                f"  {v['contract']} @ {v['scope']}: {' -> '.join(v['trace'])}"
            )
        raise AssertionError("\n".join(lines))
    return report


def format_conformance(report: dict) -> str:
    """The human table behind ``dsort report --conform``."""
    lines = [
        f"trace conformance: {report['checked']} scoped trace(s) against "
        f"{len(report['contracts'])} contract(s) — "
        + ("OK" if report["ok"] else
           f"{len(report['violations'])} VIOLATION(S)")
    ]
    for name, row in sorted(report["contracts"].items()):
        lines.append(
            f"  {name:<20} {row['checked']:>5} checked  "
            f"{row['violations']:>3} violation(s)"
        )
    for v in report["violations"]:
        lines.append(
            f"  VIOLATED {v['contract']} @ {v['scope']}: "
            + " -> ".join(v["trace"])
        )
    return "\n".join(lines) + "\n"
