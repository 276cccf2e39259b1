"""The port's gateway units against the reference's, on the same inputs.

Each flow drives one package's modules with a fake clock (and, where a
draw is random, a seeded one) and returns the decisions it saw: route
picks, health states and ejection counters, admission verdicts with their
``retry_after_s``, backoff draws, ring owners, tail-sampling verdicts and
the wire envelope of every ``ServeError`` type. Each test runs its flow
through the reference (``tfk8s_tpu``) and the port (``tfk8s_tpu_torch``)
and holds the two records equal; the flows also assert the reference's
own expectations (``tests/test_gateway.py``, ``tests/test_gateway_health.py``,
``tests/test_request_tracing.py``), so equal records are the right ones.
"""

import functools
import random
import types

import pytest

import tfk8s_tpu.api.types as r_types
import tfk8s_tpu.client.ratelimit as r_ratelimit
import tfk8s_tpu.client.store as r_store
import tfk8s_tpu.gateway.admission as r_admission
import tfk8s_tpu.gateway.affinity as r_affinity
import tfk8s_tpu.gateway.client as r_client
import tfk8s_tpu.gateway.health as r_health
import tfk8s_tpu.gateway.router as r_router
import tfk8s_tpu.gateway.server as r_gwserver
import tfk8s_tpu.obs.trace as r_trace
import tfk8s_tpu.runtime.handoff as r_handoff
import tfk8s_tpu.runtime.paging as r_paging
import tfk8s_tpu.runtime.server as r_server
import tfk8s_tpu.trainer.serve_controller as r_sc
import tfk8s_tpu.utils.logging as r_logging
import tfk8s_tpu_torch.api.types as t_types
import tfk8s_tpu_torch.client.ratelimit as t_ratelimit
import tfk8s_tpu_torch.client.store as t_store
import tfk8s_tpu_torch.gateway.admission as t_admission
import tfk8s_tpu_torch.gateway.affinity as t_affinity
import tfk8s_tpu_torch.gateway.client as t_client
import tfk8s_tpu_torch.gateway.health as t_health
import tfk8s_tpu_torch.gateway.router as t_router
import tfk8s_tpu_torch.gateway.server as t_gwserver
import tfk8s_tpu_torch.obs.trace as t_trace
import tfk8s_tpu_torch.runtime.handoff as t_handoff
import tfk8s_tpu_torch.runtime.paging as t_paging
import tfk8s_tpu_torch.runtime.server as t_server
import tfk8s_tpu_torch.trainer.serve_controller as t_sc
import tfk8s_tpu_torch.utils.logging as t_logging
import _torch_threads  # noqa: F401  (torch's threads under xdist)


def _pkg(types_, ratelimit, store, admission, affinity, client, health, router, gwserver,
         trace, handoff, paging, server, sc, logging_):
    return types.SimpleNamespace(
        types=types_, ratelimit=ratelimit, store=store, admission=admission,
        affinity=affinity, client=client, health=health, router=router, gwserver=gwserver,
        trace=trace, handoff=handoff, paging=paging, server=server, sc=sc,
        Metrics=logging_.Metrics)


REF = _pkg(r_types, r_ratelimit, r_store, r_admission, r_affinity, r_client, r_health,
           r_router, r_gwserver, r_trace, r_handoff, r_paging, r_server, r_sc, r_logging)
PORT = _pkg(t_types, t_ratelimit, t_store, t_admission, t_affinity, t_client, t_health,
            t_router, t_gwserver, t_trace, t_handoff, t_paging, t_server, t_sc, t_logging)

A, B, C = "default/p-a", "default/p-b", "default/p-c"


class FakeClock:
    def __init__(self, now=100.0):
        self.now = now

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _table(P, clock, **kw):
    kw.setdefault("metrics", P.Metrics())
    return P.router.RouteTable(clientset=None, name="s", clock=clock, **kw)


def _seed(t, *keys):
    for k in keys:
        t.observe(k, 0.0)


def _counters(metrics, prefix):
    return sorted((k, v) for k, v in metrics.snapshot()["counters"].items()
                  if k.startswith(prefix))


# -- RouteTable: picks, in-flight correction, ageing, drains, EMA ---------


def flow_route(P):
    rec = []
    t = _table(P, FakeClock())
    t.observe(A, 10.0)
    t.observe(B, 2.0)
    t.observe(C, 5.0)
    rec.append(t.pick())
    assert rec[-1] == B

    t = _table(P, FakeClock())
    for key in (A, B, C):
        t.observe(key, 1.0)
    picks = [t.pick() for _ in range(6)]
    assert sorted(picks) == [A, A, B, B, C, C]
    rec.append(picks)

    t = _table(P, FakeClock())
    t.observe(A, 0.0)
    t.observe(B, 0.5)
    rec += [t.pick(), t.pick()]
    t.release(A)
    rec.append(t.pick())
    assert rec[-3:] == [A, B, A]

    clock = FakeClock()
    t = _table(P, clock, stale_after_s=3.0)
    t.observe("default/p-old", 0.0)
    clock.advance(2.0)
    t.observe("default/p-new", 5.0)
    clock.advance(2.0)
    rec += [t.pick(), t.targets()]
    clock.advance(2.0)
    rec += [t.pick(), t.least_depth()]
    assert rec[-2:] == [None, float("inf")]

    t = _table(P, FakeClock())
    t.observe(A, 0.0)
    t.observe(B, 5.0)
    t.mark_draining(A)
    rec.append(t.pick())
    t.observe(A, 0.0)  # a draining replica's late report is ignored
    rec.append(t.targets())
    assert [k for k, _ in rec[-1]] == [B]

    t = _table(P, FakeClock())
    t.observe(A, 10.0)
    t.observe(A, 0.0)
    (key, depth), = t.targets()
    assert depth == pytest.approx((1 - P.sc.EMA_ALPHA) * 10.0)
    rec.append((key, depth, P.router.EMA_ALPHA))

    t = _table(P, FakeClock())
    t.observe(A, 0.0)
    t.observe(B, 9.0)
    rec += [t.pick(exclude={A}), t.pick(exclude={A, B})]
    return rec


# -- ReplicaHealth and the RouteTable's ejection, probes and removals ------


def flow_health_unit(P):
    H = P.health
    rec = []
    h = H.ReplicaHealth()
    rec += [h.state, h.routable(0.0), h.note_transport_error()]
    h = H.ReplicaHealth()
    rec.append([h.note_transport_error() for _ in range(H.EJECT_AFTER_ERRORS)])
    assert rec[-1][-1] == "eject"
    h = H.ReplicaHealth()
    h.note_transport_error()
    h.note_transport_error()
    h.note_ok(0.01, 0.5)
    rec += [h.state, h.consec_errors, h.note_transport_error()]
    h = H.ReplicaHealth()
    rec.append([h.note_deadline() for _ in range(H.DEADLINE_MIN_SAMPLES)])
    h = H.ReplicaHealth()
    for _ in range(H.DEADLINE_WINDOW - 1):
        h.note_ok(0.01, 0.5)
    rec.append(h.note_deadline())
    h = H.ReplicaHealth()
    for _ in range(H.GRAY_MIN_SAMPLES):
        h.note_ok(0.2, 0.5)
    fast = H.ReplicaHealth()
    for _ in range(H.GRAY_MIN_SAMPLES):
        fast.note_ok(H.GRAY_FLOOR_S / 10, 0.5)
    rec += [H.is_gray(h, 0.01), H.is_gray(h, 0.0), H.is_gray(fast, 1e-4)]
    assert rec[-3:] == [True, False, False]
    h = H.ReplicaHealth()
    h.eject(0.0)
    cooldowns = [h.cooldown_s]
    for _ in range(20):
        h.eject(0.0, escalate=True)
        cooldowns.append(h.cooldown_s)
    rec.append(cooldowns)
    assert cooldowns[0] < cooldowns[-1] <= H.EJECT_COOLDOWN_MAX_S
    h = H.ReplicaHealth()
    h.eject(10.0)
    rec += [h.routable(10.0 + h.cooldown_s / 2), h.routable(10.0 + h.cooldown_s + 0.01)]
    h.probe_inflight = H.PROBE_MAX_INFLIGHT
    rec.append(h.routable(10.0 + h.cooldown_s + 0.01))
    return rec


def flow_ejection(P):
    H = P.health
    rec = []

    def eject(t, key):
        for _ in range(H.EJECT_AFTER_ERRORS):
            t.report_outcome(key, "transport_error")

    m = P.Metrics()
    t = _table(P, FakeClock(), metrics=m)
    _seed(t, A, B)
    eject(t, A)
    rec += [t.health_state(A), t.pick(), t.targets()]
    assert rec[-3] == H.EJECTED and rec[-2] == B

    t = _table(P, FakeClock())
    _seed(t, A, B)
    t.report_outcome(A, "transport_error")
    rec += [t.health_state(A), t.pick()]

    t = _table(P, FakeClock())  # the availability floor: never below one
    _seed(t, A)
    for _ in range(H.EJECT_AFTER_ERRORS * 2):
        t.report_outcome(A, "transport_error")
    rec += [t.health_state(A), t.pick()]
    assert rec[-2:] == [H.SUSPECT, A]
    _seed(t, B)
    eject(t, A)
    rec.append(t.health_state(A))

    t = _table(P, FakeClock(), metrics=m)
    _seed(t, A, B)
    for _ in range(H.DEADLINE_MIN_SAMPLES):
        t.report_outcome(A, "deadline")
    rec.append(t.health_state(A))

    t = _table(P, FakeClock(), metrics=m)
    _seed(t, A, B, C)
    for _ in range(H.GRAY_MIN_SAMPLES):
        t.report_outcome(A, "ok", 0.5)
        t.report_outcome(B, "ok", 0.005)
        t.report_outcome(C, "ok", 0.005)
    rec.append(t.health_state(A))

    t = _table(P, FakeClock())
    _seed(t, A, B, C)
    for _ in range(H.GRAY_MIN_SAMPLES):
        for k in (A, B, C):
            t.report_outcome(k, "ok", 0.5)
    rec.append([t.health_state(k) for k in (A, B, C)])

    # the half-open probe: readmit on success, one probe at a time, a
    # failed probe re-ejects with a longer cooldown
    clock = FakeClock()
    t = _table(P, clock)
    _seed(t, A, B)
    eject(t, A)
    rec.append([t.pick() for _ in range(4)])
    clock.advance(H.EJECT_COOLDOWN_S + 0.01)
    rec += [t.pick(), t.pick()]
    assert rec[-2:] == [A, B]
    t.report_outcome(A, "ok", 0.005)
    t.release(A)
    rec += [t.health_state(A), t.pick()]

    clock = FakeClock()
    t = _table(P, clock, metrics=m)
    _seed(t, A, B)
    eject(t, A)
    clock.advance(H.EJECT_COOLDOWN_S + 0.01)
    rec.append(t.pick())
    t.report_outcome(A, "transport_error")
    t.release(A)
    rec.append(t.health_state(A))
    clock.advance(H.EJECT_COOLDOWN_S + 0.01)
    rec.append(t.pick())
    rec.append(_counters(m, "tfk8s_gateway_ejections_total"))
    assert [v for _, v in rec[-1]] == [1.0, 2.0, 1.0, 1.0]  # deadline, errors, gray, probe
    return rec


def flow_removals(P):
    rec = []
    clock = FakeClock()
    m = P.Metrics()
    t = _table(P, clock, metrics=m, stale_after_s=1.0)
    _seed(t, A, B)
    clock.advance(0.5)
    t.observe(B, 0.0)
    clock.advance(0.6)
    rec.append(t.pick())
    t = _table(P, clock, metrics=m)
    _seed(t, A, B)
    t.mark_draining(A)
    rec.append(t.targets())
    t = _table(P, clock, metrics=m)
    _seed(t, A, B)
    t.remove(A)
    rec.append(t.targets())
    rec.append(_counters(m, "tfk8s_gateway_replica_removed_total"))
    assert len(rec[-1]) == 3
    t = _table(P, clock)
    _seed(t, A)
    t.pick()
    stamp = t.last_pick_s(A)
    t.release(A)
    t.remove(A)
    rec += [stamp, t.last_pick_s(A)]
    t = _table(P, clock)
    _seed(t, A, B)
    t.observe(B, 50.0)
    for _ in range(P.health.EJECT_AFTER_ERRORS):
        t.report_outcome(A, "transport_error")
    rec.append(t.least_depth())
    assert rec[-1] > 1.0
    return rec


# -- TenantAdmission, shed_threshold, retry_after_s ------------------------


def flow_admission(P, clock):
    T = P.types
    rec = [[P.admission.shed_threshold(p) for p in (0, 1, 2, 7, -3)]]
    assert rec[0] == [0.5, 0.75, 1.0, 1.0, 0.5]

    def policy(tenants=None, default=None, enabled=True):
        return T.TenantPolicy(enabled=enabled, tenants=tenants or {},
                              default_quota=default or T.TenantQuota(qps=0.0))

    def attempt(adm, tenant, depth, limit=64):
        try:
            release = adm.admit(tenant, depth=depth, limit=limit)
        except (P.server.QuotaExceeded, P.server.Overloaded) as e:
            return (type(e).__name__, getattr(e, "tenant", None),
                    getattr(e, "reason", None), getattr(e, "shed_reason", None),
                    e.retry_after_s, getattr(e, "queue_depth", None))
        return release

    adm = P.admission.TenantAdmission()
    adm.configure(policy(enabled=False))
    rec.append([attempt(adm, "x", 1e9, 1)() for _ in range(3)])

    adm = P.admission.TenantAdmission()
    adm.configure(policy({"t": T.TenantQuota(qps=1.0, burst=1)}))
    attempt(adm, "t", 0)()
    clock.advance(0.25)
    rec.append(attempt(adm, "t", 0))
    assert rec[-1][:3] == ("QuotaExceeded", "t", "qps") and rec[-1][4] == pytest.approx(0.75)

    adm = P.admission.TenantAdmission()
    adm.configure(policy({"t": T.TenantQuota(qps=0.0, max_concurrency=1)}))
    release = attempt(adm, "t", 0)
    rec.append(attempt(adm, "t", 0))
    release()
    rec.append(callable(attempt(adm, "t", 0)))

    adm = P.admission.TenantAdmission()
    adm.configure(policy({"lo": T.TenantQuota(qps=0.0, priority=0),
                          "mid": T.TenantQuota(qps=0.0, priority=1),
                          "hi": T.TenantQuota(qps=0.0, priority=2)}))
    for tenant, depth in (("lo", 50), ("mid", 50), ("hi", 50), ("mid", 75), ("hi", 75),
                          ("hi", 100)):
        got = attempt(adm, tenant, depth, 100)
        rec.append(got if isinstance(got, tuple) else (tenant, "admitted", adm.inflight(tenant)))
    assert rec[-6][0] == "Overloaded" and rec[-6][3] == "priority"
    rec.append([adm.priority_of(t) for t in ("lo", "mid", "hi", "nobody")])

    adm = P.admission.TenantAdmission()
    adm.configure(policy(default=T.TenantQuota(qps=1.0, burst=1)))
    attempt(adm, "stranger", 0)()
    rec.append(attempt(adm, "stranger", 0))

    adm = P.admission.TenantAdmission()
    adm.configure(policy({"t": T.TenantQuota(qps=1.0, burst=1)}))
    attempt(adm, "t", 0)()
    adm.configure(policy({"t": T.TenantQuota(qps=1.0, burst=1),
                          "other": T.TenantQuota(qps=5.0, burst=5)}))
    rec.append(attempt(adm, "t", 0))
    adm.configure(policy({"t": T.TenantQuota(qps=10.0, burst=10)}))
    rec.append(callable(attempt(adm, "t", 0)))
    return rec


# -- jittered_backoff and the token bucket's delay -------------------------


def flow_backoff(P, clock):
    random.seed(20)
    draws = [P.server.jittered_backoff(hint, 0.05) for hint in (0.2, None, 0.0, 1.5, -1.0)]
    assert 0.1 <= draws[0] < 0.3 and 0.025 <= draws[1] < 0.075
    b = P.ratelimit.TokenBucketRateLimiter(qps=2.0, burst=1, clock=clock)
    delays = [b.try_accept_or_delay(), b.try_accept_or_delay()]
    clock.advance(delays[-1])
    delays.append(b.try_accept_or_delay())
    assert delays == [0.0, pytest.approx(0.5), 0.0]
    return [draws, delays]


# -- the affinity ring and affinity-routed picks ---------------------------


def flow_affinity(P):
    rng = random.Random(7)
    prompts = [[rng.randrange(1, 500) for _ in range(rng.randrange(8, 40))] for _ in range(40)]
    keys = [P.affinity.affinity_key_of(p, 8) for p in prompts]
    ring = P.affinity.AffinityRing()
    members = [f"default/p-{i}" for i in range(5)]
    for m in members:
        ring.add(m)
    owners = [ring.owner(k) for k in keys]
    assert len(set(owners)) > 1
    cands = [ring.candidates(k, limit=3) for k in keys[:8]]
    ring.remove(members[2])
    moved = [ring.owner(k) for k in keys]
    assert all(a == b for a, b in zip(owners, moved) if a != members[2])
    t = _table(P, FakeClock(), affinity=True)
    for m in members[:3]:
        t.observe(m, 0.0)
    picks = [t.pick(affinity_key=k) for k in keys[:10]]
    for m in members[:3]:
        t.observe(m, 0.0)
    spill = []
    for _ in range(int(P.affinity.AFFINITY_SPILL_DEPTH) + 2):
        spill.append(t.pick(affinity_key=keys[0]))
    chain = P.paging.prefix_digest_chain(prompts[0], 8, len(prompts[0]) // 8)
    return [keys, owners, cands, moved, picks, spill, chain, ring.describe(),
            t.ring_describe()]


# -- tail sampling ----------------------------------------------------------


def _decision_span(P, duration=0.001, status="ok", attributes=None):
    return P.trace.Span(name="gateway.request", trace_id="ab" * 16, span_id="cd" * 8,
                        parent_id=None, start_time=100.0, end_time=100.0 + duration,
                        attributes=dict(attributes or {}), status=status)


def flow_tail_sampler(P, monkeypatch):
    S = P.trace.TailSampler
    rec = []
    s = S(keep_probability=0.0)
    rec += [s.decide(_decision_span(P, status="error")),
            s.decide(_decision_span(P, attributes={"http.status_code": 429})),
            s.decide(_decision_span(P, attributes={"http.status_code": 504})),
            s.decide(_decision_span(P, attributes={"http.status_code": 200})),
            s.decide(_decision_span(P, attributes={"http.status_code": "junk"}))]
    assert rec[:4] == [(True, "error"), (True, "status_code"), (True, "status_code"),
                       (False, "sampled")]
    rec.append(S(keep_probability=0.0).decide(_decision_span(P, duration=5.0)))
    s = S(keep_probability=0.0)
    rec.append([s.decide(_decision_span(P, duration=0.01))
                for _ in range(S.MIN_TAIL_SAMPLES)])
    rec += [s.decide(_decision_span(P, duration=1.0)),
            s.decide(_decision_span(P, duration=0.01))]
    assert rec[-2:] == [(True, "slow"), (False, "sampled")]
    s = S(keep_probability=0.5, rng=random.Random(0))
    rec.append([s.decide(_decision_span(P)) for _ in range(64)])
    assert {k for k, _ in rec[-1]} == {True, False}
    rec += [S(keep_probability=1.0).decide(_decision_span(P)),
            S(keep_probability=0.0).decide(_decision_span(P))]
    for value in ("0.25", "junk", "7", "-1"):
        monkeypatch.setenv(P.trace.TRACE_SAMPLE_ENV, value)
        rec.append(S().keep_probability)
    monkeypatch.delenv(P.trace.TRACE_SAMPLE_ENV)
    rec += [S().keep_probability, P.trace.TRACE_SAMPLE_ENV, P.trace.DEFAULT_KEEP_PROBABILITY,
            P.trace.MAX_PENDING_SPANS_PER_TRACE, P.trace.MAX_PENDING_TRACES,
            P.trace.MAX_VERDICTS]
    assert rec[-10:-6] == [0.25, P.trace.DEFAULT_KEEP_PROBABILITY, 1.0, 0.0]
    return rec


def flow_tracer_sampling(P, monkeypatch):
    rec = []
    m = P.Metrics()
    t = P.trace.Tracer(sampler=P.trace.TailSampler(keep_probability=0.0), metrics=m)
    t.set_metrics(m)
    with t.start_span("gateway.request", tail_sample=True) as root:
        with t.start_span("serve.request"):
            pass
    rec += [t.spans(), dict(t.dropped), t.verdict(root.trace_id),
            _counters(m, "tfk8s_trace_spans_dropped_total")]
    assert rec[:3] == [[], {"sampled": 2}, False]

    t = P.trace.Tracer(sampler=P.trace.TailSampler(keep_probability=0.0))
    root = t.start_span("gateway.request", tail_sample=True)
    root.set_attribute("http.status_code", 429)
    late = t.start_span("gateway.client.request", traceparent=root.traceparent)
    with root:
        pass
    rec.append(t.verdict(root.trace_id))
    with late:
        pass
    rec += [sorted(s.name for s in t.spans()), t.spans()[0].attributes.get("sampling.reason")]
    assert rec[-3:] == [True, ["gateway.client.request", "gateway.request"], "status_code"]
    recent = P.trace.recent_request_traces(t)
    rec.append([(len(r["spans"]), r["root"]["name"]) for r in recent])

    t = P.trace.Tracer(sampler=P.trace.TailSampler(keep_probability=0.0))
    with t.start_span("reconcile"):
        pass
    rec += [[s.name for s in t.spans()], dict(t.dropped), P.trace.recent_request_traces(t)]
    assert rec[-3:] == [["reconcile"], {}, []]

    # a leaked decision span is evicted once the pending table is full
    monkeypatch.setattr(P.trace, "MAX_PENDING_TRACES", 2)
    t = P.trace.Tracer(sampler=P.trace.TailSampler(keep_probability=1.0))
    leaked = [t.start_span("gateway.request", tail_sample=True) for _ in range(3)]
    for sp in leaked:
        with t.start_span("child", parent=sp):
            pass
    rec.append(dict(t.dropped))
    for sp in reversed(leaked):
        t._finish(sp)
    rec += [len(t.spans()), dict(t.dropped)]

    m = P.Metrics()
    t = P.trace.Tracer(capacity=2, metrics=m)
    for i in range(3):
        t.record_span(f"s{i}", 0.0, 1.0)
    rec += [dict(t.dropped), _counters(m, "tfk8s_trace_spans_dropped_total")]
    return rec


# -- the wire envelopes ----------------------------------------------------


def _errors(P):
    """One instance of every ServeError type (and the store's wire errors),
    with the fields the gateway reads."""
    S = P.server
    quota = S.QuotaExceeded("t", 0.4321, reason="concurrency")
    over = S.Overloaded(7, 8, retry_after_s=0.25)
    over_bare = S.Overloaded(3, 8)
    unavailable = P.store.Unavailable("nothing routable")
    unavailable.tried = ["default/p-a"]
    deadline = S.DeadlineExceeded("late")
    deadline.tried = ["default/p-a", "default/p-b"]
    crashed = S.ReplicaUnavailable("died")
    crashed.tried = ["default/p-c"]
    return [quota, over, over_bare, S.InvalidRequest("bad"), P.store.NotFound("nope"),
            unavailable, deadline, S.DeadlineExceeded("bare"), crashed,
            S.ReplicaUnavailable("untried"), S.Preempted("evicted"),
            P.handoff.HandoffError("skew"), S.Draining("leaving"), S.RequestFailed("model"),
            S.RowFault("row"), S.ServeError("other"), RuntimeError("plain")]


def flow_wire_errors(P):
    rec = []
    for exc in _errors(P):
        status, reason, details, headers = P.gwserver._wire_error(exc)
        body = P.gwserver._err_body(status, reason, str(exc), details)
        rec.append((type(exc).__name__, status, reason, details, headers, body))
    assert [r[1] for r in rec] == [429, 429, 429, 400, 404, 503, 504, 504, 503, 503, 503, 502,
                                   500, 500, 500, 500, 500]
    # the client's way back: each envelope re-materialized typed
    for _name, status, reason, details, headers, _body in rec[:9]:
        err = P.client._map_error(status, reason, "m", details,
                                  P.client._parse_retry_after(headers.get("Retry-After")))
        rec.append((type(err).__name__, vars(err)))
    return rec


# -- the tests -------------------------------------------------------------


def _both(flow, *args):
    return flow(REF, *args), flow(PORT, *args)


@pytest.mark.parametrize("flow", [flow_route, flow_health_unit, flow_ejection, flow_removals,
                                  flow_affinity, flow_wire_errors],
                         ids=lambda f: f.__name__[5:])
def test_decisions_equal(flow):
    ref, port = _both(flow)
    assert port == ref


@pytest.mark.parametrize("flow", [flow_admission, flow_backoff], ids=["admission", "backoff"])
def test_clocked_decisions_equal(flow, monkeypatch):
    """Admission's token buckets read the clock each package's ratelimit
    module hands them; both get one fake clock at the same instants."""
    out = []
    for P in (REF, PORT):
        clock = FakeClock()
        monkeypatch.setattr(P.admission, "TokenBucketRateLimiter",
                            functools.partial(P.ratelimit.TokenBucketRateLimiter, clock=clock))
        out.append(flow(P, clock))
    assert out[1] == out[0]


@pytest.mark.parametrize("flow", [flow_tail_sampler, flow_tracer_sampling],
                         ids=["sampler", "tracer"])
def test_tail_sampling_equal(flow, monkeypatch):
    ref, port = _both(flow, monkeypatch)
    strip = lambda rec: [[(s.name, s.attributes.get("sampling.reason")) for s in r]  # noqa: E731
                         if isinstance(r, list) and r and hasattr(r[0], "trace_id") else r
                         for r in rec]
    assert strip(port) == strip(ref)


def test_gateway_client_backoff_and_typed_errors_equal(monkeypatch):
    """The client's 429 retry loop: two sheds then a 200, the sleeps drawn
    from one seed in both packages."""
    import json

    def envelope(reason, **details):
        return json.dumps({"kind": "Status", "status": "Failure", "reason": reason,
                           "message": reason, "details": details}).encode()

    out = []
    for P in (REF, PORT):
        sleeps = []
        monkeypatch.setattr(P.client.time, "sleep", sleeps.append)
        responses = [
            (429, {"Retry-After": "0.200"}, envelope("Overloaded", queueDepth=9, queueLimit=10)),
            (429, {"Retry-After": "0.200"},
             envelope("QuotaExceeded", tenant="t", quota="qps", retryAfterS=0.2)),
            (200, {}, json.dumps({"result": {"version": "v1"}}).encode()),
        ]
        monkeypatch.setattr(P.client.GatewayClient, "_roundtrip",
                            lambda self, body, traceparent="", r=responses: r.pop(0))
        random.seed(3)
        client = P.client.GatewayClient("http://127.0.0.1:1", "s", tenant="t")
        out.append((client.request(1.0, timeout=5), list(sleeps), responses))
        assert len(sleeps) == 2 and all(0.1 <= s < 0.3 for s in sleeps)
    assert out[1] == out[0]


def test_serve_client_shed_backoff_equal(monkeypatch):
    """``ServeClient`` backs off for each shed's jittered Retry-After and
    retries; the same seed gives both packages the same sleeps."""
    out = []
    for P in (REF, PORT):
        calls, sleeps = [], []

        class Shedding:
            def submit(self, payload, timeout=None, **kw):
                calls.append(payload)
                if len(calls) <= 2:
                    raise P.server.Overloaded(10, 10, retry_after_s=0.2)
                return {"ok": payload}

        replica = Shedding()
        monkeypatch.setattr(P.server.time, "sleep", sleeps.append)
        monkeypatch.setattr(P.server, "lookup_replica", lambda key: replica)
        monkeypatch.setattr(P.server.ServeClient, "ready_replica_keys",
                            lambda self, refresh=False: ["default/p-0"])
        random.seed(11)
        got = P.server.ServeClient(None, "s").request(1.0, timeout=5)
        out.append((got, len(calls), list(sleeps)))
    assert out[1] == out[0]
    assert out[0][1] == 3


def test_template_hash_and_readiness_equal():
    """One wire fragment hashes alike; readiness reads the same pod fields."""
    frag = {"task": "gpt", "checkpoint": "seed:0", "template": {"env": {"A": "1"}},
            "batching": {"maxBatchSize": 8}}
    assert t_server.template_hash(frag) == r_server.template_hash(frag)
    for P in (REF, PORT):
        T = P.types
        pod = T.Pod(metadata=T.ObjectMeta(name="p"))
        states = [P.server.replica_is_ready(pod)]
        pod.status.phase = T.PodPhase.RUNNING
        states.append(P.server.replica_is_ready(pod))
        pod.status.training["serving_ready"] = 1.0
        states.append(P.server.replica_is_ready(pod))
        pod.metadata.deletion_timestamp = 1.0
        states.append(P.server.replica_is_ready(pod))
        assert states == [False, False, True, False]


def test_drain_hooks_fire_once_each_and_outside_the_lock():
    """The port's table fires the port's hooks once per unregister, from
    outside its lock (a hook may look the table up); a failing hook does
    not stop the others; the reference's hooks never hear of it."""
    seen_port, seen_ref = [], []

    def lookup_hook(key):  # would deadlock if fired under the lock
        seen_port.append((key, t_server.lookup_replica(key)))

    def bad_hook(key):
        raise RuntimeError("a bad subscriber")

    t_server.add_drain_hook(lookup_hook)
    t_server.add_drain_hook(bad_hook)
    r_server.add_drain_hook(seen_ref.append)
    try:
        t_server.register_replica("default/hook-p", object())
        t_server.unregister_replica("default/hook-p")
    finally:
        t_server.remove_drain_hook(lookup_hook)
        t_server.remove_drain_hook(bad_hook)
        t_server.remove_drain_hook(bad_hook)  # removing twice is a no-op
        r_server.remove_drain_hook(seen_ref.append)
    assert seen_port == [("default/hook-p", None)]
    assert seen_ref == []
