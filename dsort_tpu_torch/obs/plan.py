"""The planner: journaled signals in, journaled decisions out.

Counterpart of ``dsort_tpu/obs/plan.py``, decision for decision: the
same policies, thresholds and reasons, so the same inputs through either
package's `replay_decision` give the same ``(chosen, rejected)`` and a
journal either package wrote replays into an equal `Planner.state_dict`.
The backend-free `Planner` consumes signals the tree already journals —
the admission mix (``job_admitted``), device-memory watermarks
(``hbm_watermark``), losses (``worker_dead``) — and emits typed
``plan_decision`` events (policy, chosen value, the measured inputs, the
rejected alternatives) before dispatch.  Every policy is a pure function
of the ``inputs`` its event carries: `replay_decision(policy, inputs)`
recomputes the choice from the journal alone.

Precedence is strict and journaled: explicit flag > conf file > planner.
The planner fills only knobs the user left unset (`JobConfig.explicit`);
an explicit value that wins while autotune is on journals a
``plan_override`` with what the planner would have chosen.

Seams: `planned_exchange` (`parallel.sample_sort.SampleSort`, per
dispatch; ``fused_ok`` is "the mesh is on a CUDA device", where the fused
ring kernel exists), `planned_wave_elems` (`models.wave_sort.
ExternalWaveSort`) and `planned_slice_devices` (`serve.SortService`).
numpy only: no torch, so a journal of decisions analyses anywhere.
"""

from __future__ import annotations

import threading
from collections import Counter, deque

import numpy as np

#: The policy catalog — one entry per knob the planner may fill.
PLAN_POLICIES = (
    "exchange", "wave_elems", "redundancy", "redundancy_mode", "prewarm",
    "dispatch_timeout_s", "slice_devices",
)

#: Fields every ``plan_decision`` event carries (schema, test-enforced).
PLAN_DECISION_FIELDS = ("policy", "chosen", "inputs", "rejected")
#: Fields every ``plan_override`` event carries.
PLAN_OVERRIDE_FIELDS = ("policy", "explicit", "planned", "inputs")

# -- policy constants (the documented thresholds of ARCHITECTURE §15) --------

#: Plan-phase skew ratio (``max_mean_ratio``) at or above which the
#: measured-capacity ring schedule beats the padded all_to_all: the padded
#: collective sizes EVERY (src, dst) bucket at the max, so its wire bytes
#: and merge work scale with the ratio while the ring's stay ~flat.
SKEW_RING_THRESHOLD = 2.0
#: Keys sampled by the pre-dispatch skew probe (deterministic stride).
SKEW_PROBE_SAMPLE = 1 << 16
#: Fraction of device memory a wave may occupy (headroom for the exchange
#: buffers, the merge scratch, and the next wave's H2D overlap).
WAVE_HBM_BUDGET_FRAC = 0.6
#: Static working-set model: bytes touched per key per wave when no
#: ``hbm_watermark`` has been observed yet (sorted copy + exchange
#: capacity buffers + merge scratch).
WAVE_WORKING_SET_FACTOR = 8.0
WAVE_MIN_ELEMS = 1 << 18
WAVE_MAX_ELEMS = 1 << 26
#: Degraded-agent fraction at or above which the fleet buys a replica.
REDUNDANCY_DEGRADED_FRAC = 0.25
#: Post-exchange keys per device a small-job slice should stay under —
#: above it a wider slice spreads the merge; the slice_devices policy
#: picks the smallest power-of-two device count meeting it at the
#: admission mix's p90 rung.
SLICE_KEYS_PER_DEVICE = 1 << 20
#: Admissions remembered for the prewarm rung x dtype mix.
PREWARM_HISTORY = 64
#: Headroom multiplier over the observed p99 dispatch-accept latency: the
#: planned send deadline must absorb a tail excursion without failing over a
#: healthy-but-momentarily-slow agent (the failover re-route costs a full
#: re-dispatch plus a journaled job_rerouted).
DISPATCH_TIMEOUT_HEADROOM = 8.0
#: Floor for the planned send deadline — below this the socket round-trip
#: itself (connect + encode + accept) dominates the budget.
DISPATCH_TIMEOUT_MIN_S = 1.0
#: Dispatch-accept latencies remembered for the rolling p99.
DISPATCH_LATENCY_HISTORY = 256


def plan_rung(n: int) -> int:
    """The 8-aligned 1/8-power-of-two capacity-ladder rung for ``n`` keys.

    Same math as `models.pipelines.pad_rung` (test-pinned against it),
    kept here so the planner stays free of torch.
    """
    n = max(int(n), 1)
    step = max(8, 1 << max((n - 1).bit_length() - 3, 0))
    return -(-n // step) * step


def plan_ladder(hi: int, lo: int = 8) -> list[int]:
    """Ladder rungs in ``[lo, hi]`` — the reference's ``ladder_rungs``
    enumeration (test-pinned against it)."""
    lo = max(int(lo), 8)
    step = max(8, 1 << max((lo - 1).bit_length() - 3, 0))
    r = -(-lo // step) * step
    out: list[int] = []
    while r <= hi:
        out.append(r)
        r += max(8, 1 << max(r.bit_length() - 3, 0))
    return out


def variant_key_label(rung: int, dtype: str) -> str:
    """The journal-safe prewarm-set member: ``"<rung>:<dtype>"`` (tuples
    would come back from JSON as lists and break replay equality)."""
    return f"{int(rung)}:{dtype}"


# -- the pre-dispatch skew probe ---------------------------------------------

def probe_skew(data, num_workers: int, sample: int = SKEW_PROBE_SAMPLE) -> dict:
    """Sampled estimate of the plan-phase bucket histogram's skew.

    A deterministic stride-sample of ``data`` is sorted, split at the
    same equal-rank splitters the device plan targets, and reduced to the
    ``max_mean_ratio`` headline `parallel.exchange.skew_stats` computes —
    so the decision's measured input is directly comparable to the
    ``skew_report`` the chosen ring plan then journals from the exact
    histogram.  Host-side, numpy-only, O(sample log sample).
    """
    data = np.asarray(data)
    p = max(int(num_workers), 1)
    n = len(data)
    if n == 0 or p < 2:
        return {"max_mean_ratio": 1.0, "sample": 0, "num_workers": p,
                "n_keys": int(n)}
    stride = max(n // int(sample), 1)
    xs = np.sort(data[::stride][: int(sample)].astype(np.int64, copy=False))
    k = len(xs)
    # Equal-rank splitters over the sample, then bucket counts — the
    # sampled twin of `_choose_splitters` + the plan histogram.
    cut = [min((i + 1) * k // p, k - 1) for i in range(p - 1)]
    splitters = xs[cut]
    counts = np.diff(np.searchsorted(xs, splitters, side="right"),
                     prepend=0, append=k).astype(np.int64)
    mean = float(counts.mean())
    ratio = float(counts.max()) / mean if mean > 0 else 1.0
    return {
        "max_mean_ratio": round(ratio, 3),
        "sample": int(k),
        "num_workers": p,
        "n_keys": int(n),
    }


# -- the pure policies (decision == f(inputs), replayable) -------------------

def _decide_exchange(inputs: dict) -> tuple[str, list[dict]]:
    skew = float(inputs.get("max_mean_ratio", 1.0))
    p = int(inputs.get("num_workers", 1))
    fused_ok = bool(inputs.get("fused_ok", False))
    red = int(inputs.get("redundancy", 1))
    thr = SKEW_RING_THRESHOLD
    if p < 2:
        return "alltoall", [
            {"value": "ring", "reason": "single worker: no exchange steps"},
            {"value": "fused", "reason": "single worker: no exchange steps"},
        ]
    if red > 1:
        return "ring", [
            {"value": "alltoall",
             "reason": f"redundancy={red}: the padded collective has no "
                       "per-step seam for the replica plane"},
            {"value": "fused",
             "reason": f"redundancy={red}: the fused kernel carries no "
                       "replica slots"},
        ]
    hosts = int(inputs.get("hosts", 0))
    if hosts >= 2 and p // hosts >= 2:
        # A >=2-host grouping with >=2 devices per host: the two-level
        # schedule aggregates each host's contributions per destination
        # host and ships ONE merged transfer per (src-host, dst-host)
        # pair, so the DCN leg scales with the data crossing hosts, not
        # with P.  At 1 device/host there is nothing to aggregate (every
        # transfer is already cross-host) — fall through to the flat
        # skew decision.
        d = p // hosts
        return "hier", [
            {"value": "alltoall",
             "reason": f"{hosts}-host topology: the padded collective "
                       "ships every (src, dst) device bucket across hosts "
                       "individually; aggregation sends one merged "
                       "transfer per host pair on the DCN leg"},
            {"value": "ring",
             "reason": f"{hosts}-host topology ({d} devices/host): the "
                       "flat ring pushes full per-device buffers over the "
                       "host boundary on most steps; the two-level "
                       "schedule moves that traffic onto the intra-host "
                       "fabric"},
            {"value": "fused",
             "reason": "the fused kernel runs the FLAT ring schedule; it "
                       "has no host-aggregated DCN leg"},
        ]
    if skew >= thr:
        rejected = [
            {"value": "alltoall",
             "reason": f"measured skew {skew} >= {thr}: the padded "
                       "collective sizes every bucket at the max "
                       "(max_bucket x P wire bytes and merge work)"},
        ]
        if fused_ok:
            rejected.append(
                {"value": "ring",
                 "reason": "same measured schedule, but P-1 separate "
                           "dispatches vs one fused launch"})
            return "fused", rejected
        # The reference's words, kept: the two packages' replays compare
        # (chosen, rejected) whole.  Here "gated" is a mesh on the CPU.
        rejected.append(
            {"value": "fused",
             "reason": "Pallas ring kernel is TPU-gated on this backend"})
        return "ring", rejected
    return "alltoall", [
        {"value": "ring",
         "reason": f"measured skew {skew} < {thr}: per-step measured caps "
                   "save no wire bytes and P-1 dispatches cost more than "
                   "one collective"},
        {"value": "fused",
         "reason": f"measured skew {skew} < {thr}: nothing for the fused "
                   "measured schedule to win back"},
    ]


def _decide_wave_elems(inputs: dict) -> tuple[int, list[dict]]:
    cur = int(inputs.get("current", WAVE_MIN_ELEMS))
    itemsize = max(int(inputs.get("itemsize", 4)), 1)
    devbytes = int(inputs.get("max_device_bytes", 0) or 0)
    peak = int(inputs.get("peak_bytes", 0) or 0)
    if devbytes <= 0:
        return cur, [
            {"value": "resize",
             "reason": "no device memory stats (cpu backend or no "
                       "hbm_watermark observed): keeping wave_elems"},
        ]
    budget = int(devbytes * WAVE_HBM_BUDGET_FRAC)
    if peak > 0:
        per_elem = max(float(peak) / max(cur, 1), float(itemsize))
        basis = f"measured hbm_watermark peak {peak} B at {cur} elems/wave"
    else:
        per_elem = itemsize * WAVE_WORKING_SET_FACTOR
        basis = (f"static working-set model ({WAVE_WORKING_SET_FACTOR:g} x "
                 f"{itemsize} B/key)")
    target = max(int(budget / per_elem), 2)
    chosen = 1 << max(target.bit_length() - 1, 1)
    chosen = max(WAVE_MIN_ELEMS, min(WAVE_MAX_ELEMS, chosen))
    rejected = [
        {"value": chosen * 2,
         "reason": f"{basis}: predicted {int(chosen * 2 * per_elem)} B "
                   f"exceeds the {budget} B budget "
                   f"({WAVE_HBM_BUDGET_FRAC:g} x {devbytes} B device)"},
    ]
    if chosen != cur:
        rejected.append({"value": cur, "reason": f"{basis}: resized"})
    return chosen, rejected


def _decide_redundancy(inputs: dict) -> tuple[int, list[dict]]:
    agents = int(inputs.get("agents", 0))
    degraded = int(inputs.get("degraded", 0))
    losses = int(inputs.get("loss_events", 0))
    cur = int(inputs.get("current", 1))
    if agents <= 0 and losses == 0:
        return cur, [
            {"value": "resize",
             "reason": "no fleet health signal observed: keeping redundancy"},
        ]
    frac = degraded / agents if agents > 0 else 0.0
    if losses > 0 or frac >= REDUNDANCY_DEGRADED_FRAC:
        why = (f"{losses} loss event(s), {degraded}/{agents} agent(s) "
               f"degraded")
        return 2, [
            {"value": 1,
             "reason": f"{why}: a re-run posture re-sorts every lost key; "
                       "one replica recovers with a local merge"},
            {"value": 3,
             "reason": f"{why}: a second replica pays 3x exchange wire "
                       "bytes against a multi-loss rate nobody observed"},
        ]
    return 1, [
        {"value": 2,
         "reason": f"healthy fleet ({degraded}/{agents} degraded, "
                   f"{losses} losses): the replica wire-byte premium buys "
                   "no observed recovery"},
    ]


def _decide_redundancy_mode(inputs: dict) -> tuple[str, list[dict]]:
    """HOW a bought replica plane ships its premium (ARCHITECTURE §18).

    Deliberately a SEPARATE pure policy from `_decide_redundancy` (whose
    journaled decisions must keep replaying bit-identically): the r
    policy answers "buy availability at all?"; this one answers "full
    copies or parity slots?".  Observed LOSSES argue for full copies —
    replicate recovery needs no parity solve and tolerates a holder-set
    loss shape parity's budget might not — while a merely DEGRADED fleet
    (slow-but-alive agents, the straggler-serve case) gets parity's near
    1/P x wire premium at the same single-loss survivability.
    """
    agents = int(inputs.get("agents", 0))
    degraded = int(inputs.get("degraded", 0))
    losses = int(inputs.get("loss_events", 0))
    frac = degraded / agents if agents > 0 else 0.0
    if losses > 0:
        return "replicate", [
            {"value": "parity",
             "reason": f"{losses} observed loss event(s): full copies "
                       "recover any r-1 holder losses without a parity "
                       "solve or its erasure-budget shape limits"},
        ]
    if agents > 0 and frac >= REDUNDANCY_DEGRADED_FRAC:
        return "parity", [
            {"value": "replicate",
             "reason": f"{degraded}/{agents} agent(s) degraded but zero "
                       "losses: parity buys the same single-loss cover "
                       "(and the straggler-serve race) at ~1/P x the "
                       "(r-1)x replica wire premium"},
        ]
    return "replicate", [
        {"value": "parity",
         "reason": f"healthy fleet ({degraded}/{agents} degraded, "
                   f"{losses} losses): nothing to optimize; the default "
                   "mode keeps recovery solve-free"},
    ]


def _decide_slice_devices(inputs: dict) -> tuple[int, list[dict]]:
    """Devices per small-job serving slice, sized from the admission mix.

    The serving layer's slice width was a hand-set flag
    (``SERVE_SLICE_DEVICES``); this policy picks the smallest
    power-of-two divisor of the device count whose per-device share of
    the admission mix's p90 rung stays under `SLICE_KEYS_PER_DEVICE` —
    small jobs keep 1-device slices (maximum packing parallelism),
    a heavier mix widens the slice before the merge phase saturates a
    single chip.
    """
    ndev = int(inputs.get("num_devices", 1))
    cur = int(inputs.get("current", 1))
    rungs = [int(r) for r in inputs.get("rungs", ())]
    if ndev < 1:
        ndev = 1
    widths = [w for w in (1, 2, 4, 8, 16, 32, 64)
              if w <= ndev and ndev % w == 0]
    if not rungs:
        return cur, [
            {"value": "resize",
             "reason": "no admissions observed: keeping slice_devices"},
        ]
    p90 = int(np.percentile(rungs, 90))
    chosen = widths[-1]
    for w in widths:
        if p90 / w <= SLICE_KEYS_PER_DEVICE:
            chosen = w
            break
    rejected = []
    for w in widths:
        if w < chosen:
            rejected.append(
                {"value": w,
                 "reason": f"p90 admission rung {p90} keys / {w} device(s)"
                           f" = {p90 // w} > {SLICE_KEYS_PER_DEVICE} "
                           "keys/device: the merge phase saturates"})
        elif w > chosen:
            rejected.append(
                {"value": w,
                 "reason": f"p90 admission rung {p90} fits {chosen} "
                           "device(s); a wider slice halves the packing "
                           "parallelism for no merge relief"})
    if chosen != cur:
        rejected.append({"value": cur, "reason": "resized to the mix"})
    return chosen, rejected


def _decide_prewarm(inputs: dict) -> tuple[list, list[dict]]:
    history = [str(h) for h in inputs.get("history", ())]
    ladder = [int(r) for r in inputs.get("ladder", ())]
    dtype = str(inputs.get("dtype", "int32"))
    limit = int(inputs.get("limit", 0)) or len(ladder) or len(history)
    if not history:
        # Cold start: no admission mix to predict from — the exhaustive
        # ladder is the only honest warm set.
        return [variant_key_label(r, dtype) for r in ladder], []
    counts = Counter(history)
    ranked = sorted(counts, key=lambda lbl: (-counts[lbl], lbl))[:limit]
    chosen = sorted(ranked)
    keep = set(chosen)
    rejected = [
        {"value": variant_key_label(r, dtype),
         "reason": f"not admitted in the last {len(history)} job(s)"}
        for r in ladder if variant_key_label(r, dtype) not in keep
    ]
    return chosen, rejected


def _decide_dispatch_timeout_s(inputs: dict) -> tuple[float, list[dict]]:
    """The fleet's per-agent SEND deadline, sized from what dispatch
    actually costs: p99 of the observed accept latencies x headroom.  The
    hand-set default (request_timeout_s, 30 s) parks a job behind a stuck
    agent for the full request budget; the measured deadline fails over in
    seconds while the headroom keeps a healthy agent's tail excursion from
    tripping a spurious re-route."""
    cur = float(inputs.get("current", 0.0) or 0.0)
    p99 = float(inputs.get("p99_s", 0.0) or 0.0)
    samples = int(inputs.get("samples", 0))
    if samples <= 0 or p99 <= 0:
        return cur, [
            {"value": "resize",
             "reason": "no dispatch-accept latency observed yet: keeping "
                       "dispatch_timeout_s"},
        ]
    chosen = round(max(DISPATCH_TIMEOUT_MIN_S,
                       p99 * DISPATCH_TIMEOUT_HEADROOM), 3)
    rejected = [
        {"value": round(p99, 6),
         "reason": f"the bare p99 of {samples} accept(s) fails over a "
                   f"healthy agent on any tail excursion "
                   f"({DISPATCH_TIMEOUT_HEADROOM:g}x headroom applied)"},
    ]
    if chosen != cur:
        rejected.append(
            {"value": cur,
             "reason": f"measured p99 {p99} s x "
                       f"{DISPATCH_TIMEOUT_HEADROOM:g} headroom resized "
                       "the send deadline"})
    return chosen, rejected


_POLICY_FNS = {
    "exchange": _decide_exchange,
    "wave_elems": _decide_wave_elems,
    "redundancy": _decide_redundancy,
    "redundancy_mode": _decide_redundancy_mode,
    "prewarm": _decide_prewarm,
    "dispatch_timeout_s": _decide_dispatch_timeout_s,
    "slice_devices": _decide_slice_devices,
}


def replay_decision(policy: str, inputs: dict) -> tuple:
    """Recompute one decision from its journaled inputs — THE replay
    seam: ``plan_decision.chosen`` must equal
    ``replay_decision(policy, inputs)[0]`` for every journaled decision
    (`obs.analyze`'s ``plan`` verdict pins the mismatch count at 0)."""
    try:
        fn = _POLICY_FNS[policy]
    except KeyError:
        raise ValueError(
            f"unknown plan policy {policy!r}; registered: {PLAN_POLICIES}"
        ) from None
    return fn(dict(inputs or {}))


# -- the planner (rolling state = a fold over journal records) ---------------

class Planner:
    """Backend-free closed-loop tuner: observes journaled signals, decides.

    Attach it to a job's `Metrics` like the other live consumers
    (``planner.attach(metrics)`` — it is a standard event tap), feed it
    with `observe`, and ask it to fill knobs with `decide`.  Every
    decision emits ``plan_decision`` (and bumps ``plan_decisions``);
    every explicit-flag win emits ``plan_override``.  `state_dict` /
    `replay` pin the live-state == journal-replay contract.
    """

    def __init__(self, job=None, history: int = PREWARM_HISTORY):
        self.job = job
        self._lock = threading.Lock()
        self._admissions: deque = deque(maxlen=int(history))
        self._dispatch_lat: deque = deque(maxlen=DISPATCH_LATENCY_HISTORY)
        self._hbm_peak = 0
        self._max_device_bytes = 0
        self._loss_events = 0
        self._degraded: dict[str, bool] = {}
        self.decisions = Counter()
        self.overrides = Counter()
        self._last: dict[str, dict] = {}

    # -- signal ingestion (Metrics tap protocol) ----------------------------

    def attach(self, metrics) -> None:
        metrics.taps.append(self)

    def observe(self, etype: str, fields: dict, mono=None, metrics=None) -> None:
        """Fold one journal event into the rolling control inputs.

        The same signature as every other live tap; also the replay
        seam — `replay` calls this for each journal record, so anything
        folded here is by construction recomputable from the journal.
        """
        with self._lock:
            if etype == "job_admitted":
                n = fields.get("n_keys")
                if n:
                    self._admissions.append(variant_key_label(
                        plan_rung(int(n)), str(fields.get("dtype", "int32"))
                    ))
            elif etype == "hbm_watermark":
                self._hbm_peak = max(
                    self._hbm_peak, int(fields.get("bytes_in_use", 0) or 0)
                )
                self._max_device_bytes = max(
                    self._max_device_bytes,
                    int(fields.get("max_device_bytes", 0) or 0),
                )
            elif etype == "job_dispatched":
                # The accept round-trip the send deadline must cover — the
                # dispatch_timeout_s policy's measured input.
                lat = fields.get("accept_latency_s")
                if lat:
                    self._dispatch_lat.append(float(lat))
            elif etype == "worker_dead":
                self._loss_events += 1
            elif (etype == "job_rerouted"
                  and fields.get("reason") == "agent_lost"):
                # The fleet controller's loss signal: an agent died with
                # work on it (each re-route journals one of these).
                self._loss_events += 1
            elif etype == "health_verdict":
                aid = fields.get("agent")
                if aid is not None:
                    self._degraded[str(aid)] = bool(fields.get("degraded"))

    def state_dict(self) -> dict:
        """The rolling control inputs — exactly reproducible by `replay`
        over the journal (the live == replay pin)."""
        with self._lock:
            return {
                "admissions": list(self._admissions),
                "dispatch_latencies": [float(x) for x in self._dispatch_lat],
                "hbm_peak": self._hbm_peak,
                "max_device_bytes": self._max_device_bytes,
                "loss_events": self._loss_events,
                "degraded": dict(self._degraded),
            }

    @classmethod
    def replay(cls, records, job=None) -> "Planner":
        """Rebuild a planner's rolling state from journal records."""
        p = cls(job=job)
        for r in records:
            fields = {k: v for k, v in r.items()
                      if k not in ("type", "seq", "t", "mono")}
            p.observe(r.get("type", ""), fields)
        return p

    # -- precedence ---------------------------------------------------------

    def enabled(self) -> bool:
        return bool(self.job is not None and getattr(self.job, "autotune", False))

    def explicit_value(self, knob: str, call_value=None):
        """The winning explicit value for ``knob``, or None when the knob
        is genuinely unset (per-call override > CLI/conf explicit)."""
        if call_value is not None:
            return call_value
        if self.job is not None and knob in getattr(self.job, "explicit", ()):
            return getattr(self.job, knob, None)
        return None

    # -- decision emission --------------------------------------------------

    def decide(self, policy: str, inputs: dict, metrics=None):
        """Run one policy, journal the decision, return the chosen value."""
        chosen, rejected = replay_decision(policy, inputs)
        with self._lock:
            self.decisions[policy] += 1
            self._last[policy] = {"chosen": chosen, "inputs": dict(inputs)}
        if metrics is not None:
            metrics.bump("plan_decisions")
            metrics.event(
                "plan_decision", policy=policy, chosen=chosen,
                inputs=dict(inputs), rejected=rejected,
            )
        return chosen

    def note_override(self, policy: str, explicit, inputs: dict, metrics=None):
        """Journal an explicit-flag win: the planner yields, the journal
        records what it would have chosen.  Returns the explicit value."""
        planned, _ = replay_decision(policy, inputs)
        with self._lock:
            self.overrides[policy] += 1
        if metrics is not None:
            metrics.bump("plan_overrides")
            metrics.event(
                "plan_override", policy=policy, explicit=explicit,
                planned=planned, inputs=dict(inputs),
            )
        return explicit

    def resolve(self, policy: str, inputs: dict, metrics=None, call_value=None):
        """The one precedence seam: explicit flag > planner > caller default.

        Returns the value to use, or None when autotune is off and
        nothing was explicit (the caller's existing default applies).
        """
        explicit = self.explicit_value(policy, call_value)
        if not self.enabled():
            return explicit
        if explicit is not None:
            return self.note_override(policy, explicit, inputs, metrics)
        return self.decide(policy, inputs, metrics)

    # -- policy input builders (state -> inputs dicts) ----------------------

    def wave_inputs(self, current: int, itemsize: int,
                    max_device_bytes: int | None = None) -> dict:
        st = self.state_dict()
        return {
            "current": int(current),
            "itemsize": int(itemsize),
            "peak_bytes": st["hbm_peak"],
            "max_device_bytes": int(max_device_bytes or 0)
            or st["max_device_bytes"],
        }

    def prewarm_inputs(self, ladder, dtype: str, limit: int = 0) -> dict:
        st = self.state_dict()
        return {
            "history": st["admissions"],
            "ladder": [int(r) for r in ladder],
            "dtype": str(dtype),
            "limit": int(limit),
        }

    def dispatch_timeout_inputs(self, current: float | None = None) -> dict:
        st = self.state_dict()
        lats = st["dispatch_latencies"]
        p99 = float(np.percentile(lats, 99)) if lats else 0.0
        return {
            "current": float(current or 0.0),
            "p99_s": round(p99, 6),
            "samples": len(lats),
        }

    def redundancy_inputs(self, current: int = 1,
                          scores: dict | None = None) -> dict:
        st = self.state_dict()
        degraded = dict(st["degraded"])
        if scores is not None:
            # Controller path: the live HealthAnalyzer view supersedes the
            # folded events (same verdicts, fresher window).
            degraded = {str(a): bool(d) for a, (d, _) in scores.items()}
        return {
            "agents": len(degraded),
            "degraded": sum(1 for d in degraded.values() if d),
            "loss_events": st["loss_events"],
            "current": int(current),
        }

    def redundancy_mode_inputs(self, scores: dict | None = None) -> dict:
        """Same fleet-health signal as `redundancy_inputs`, minus the
        integer ``current`` (the mode axis has no resize semantics)."""
        inputs = self.redundancy_inputs(scores=scores)
        inputs.pop("current", None)
        return inputs

    def slice_inputs(self, current: int, num_devices: int) -> dict:
        st = self.state_dict()
        return {
            "current": int(current),
            "num_devices": int(num_devices),
            # Admission labels are "rung:dtype" (variant_key_label);
            # the slice policy sizes on the rung alone.
            "rungs": [int(lbl.split(":", 1)[0]) for lbl in st["admissions"]],
        }

    # -- snapshots ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Per-policy decision/override counts + last choice (the gauge
        and ``dsort top`` pane source)."""
        with self._lock:
            return {
                policy: {
                    "decisions": self.decisions.get(policy, 0),
                    "overrides": self.overrides.get(policy, 0),
                    "last": self._last.get(policy, {}).get("chosen"),
                }
                for policy in PLAN_POLICIES
            }


# -- the sample_sort / wave_sort module seams (no shared state needed) -------

def planned_exchange(job, data, num_workers: int, metrics=None,
                     call_value=None, fused_ok: bool = False,
                     redundancy: int | None = None, hosts: int = 0):
    """The `parallel.sample_sort.SampleSort._dispatch_keys` autotune seam.

    Returns the exchange value to resolve (explicit > planner) or None
    (autotune off, nothing explicit: the config default applies
    unplanned, exactly the pre-planner behavior).  ``hosts`` is the
    MEASURED host topology (the caller's `resolve_hier_hosts` result —
    this module does not probe the process group itself); >= 2 with >= 2
    devices per host arms the two-level "hier" schedule.  ``fused_ok`` is
    whether the fused ring kernel can run (the mesh is on a CUDA device).
    """
    if job is None or not getattr(job, "autotune", False):
        return call_value
    planner = Planner(job=job)
    explicit = planner.explicit_value("exchange", call_value)
    inputs = probe_skew(data, num_workers)
    inputs["fused_ok"] = bool(fused_ok)
    inputs["hosts"] = int(hosts)
    inputs["redundancy"] = int(
        redundancy if redundancy is not None
        else getattr(job, "redundancy", 1)
    )
    if explicit is not None:
        return planner.note_override("exchange", explicit, inputs, metrics)
    return planner.decide("exchange", inputs, metrics)


def planned_wave_elems(job, current: int, itemsize: int, records=(),
                       metrics=None, max_device_bytes: int | None = None) -> int:
    """The `models.wave_sort.ExternalWaveSort` autotune seam: size the wave from the
    journal's ``hbm_watermark`` ledger (``records``) instead of the
    hand-set default.  Returns the wave size to use."""
    if job is None or not getattr(job, "autotune", False):
        return int(current)
    planner = Planner.replay(records, job=job)
    inputs = planner.wave_inputs(current, itemsize, max_device_bytes)
    if "wave_elems" in getattr(job, "explicit", ()):
        return int(planner.note_override(
            "wave_elems", int(current), inputs, metrics
        ))
    return int(planner.decide("wave_elems", inputs, metrics))


def planned_slice_devices(job, serve, current: int, num_devices: int,
                          records=(), metrics=None) -> int:
    """The `serve.SortService` slice-width autotune seam (mirrors
    `planned_wave_elems`): size the small-job mesh sub-slice from the
    journaled admission mix instead of the hand-set
    ``SERVE_SLICE_DEVICES``.  Returns the slice width to use; the
    explicit flag/conf key wins with a journaled ``plan_override``.
    """
    if job is None or not getattr(job, "autotune", False):
        return int(current)
    planner = Planner.replay(records, job=job)
    inputs = planner.slice_inputs(current, num_devices)
    explicit = (
        "slice_devices" in getattr(job, "explicit", ())
        or (serve is not None and "slice_devices" in getattr(serve, "explicit", ()))
    )
    if explicit:
        return int(planner.note_override(
            "slice_devices", int(current), inputs, metrics
        ))
    return int(planner.decide("slice_devices", inputs, metrics))


# -- shared renderer (dsort top planner pane / report) -----------------------

def plan_table(rows, indent: str = "  ") -> str:
    """Render planner rows: ``(policy, decisions, overrides, last)``."""
    if not rows:
        return f"{indent}(no planner decisions)"
    head = f"{indent}{'policy':<12} {'decisions':>9} {'overrides':>9}  last chosen"
    lines = [head]
    for policy, dec, ovr, last in rows:
        if isinstance(last, (list, tuple)):
            shown = f"[{len(last)} key(s)]" if last else "[]"
        else:
            shown = "-" if last is None else str(last)
        lines.append(
            f"{indent}{policy:<12} {int(dec):>9} {int(ovr):>9}  {shown}"
        )
    return "\n".join(lines)
