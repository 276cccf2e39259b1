"""In-flight failure recovery behind the port's gateway against the
reference's, on the CPU.

Each flow of ``tests/test_gateway_faults.py`` runs through each package's
``GatewayServer`` with the same fake replicas, one test a flow with a
reference case and a port case (``_torch_control.held``): a replica that
dies while it holds an idempotent request is retried on a survivor,
bounded per request by ``MAX_DISPATCH_RETRIES`` and fleet-wide by the
serve's retry budget, and every terminal failure is typed and names the
replicas tried. Each case patches its own package's
``gateway.server.lookup_replica`` and raises its own package's
``ReplicaUnavailable`` and ``DeadlineExceeded``; the client-side flows run
each package's ``GatewayClient`` against one fake gateway. Held equal:
return values, fake calls, counters and their labels, health states,
``tried`` lists, exception classes (by name, each the case's own
package's), and HTTP status codes and Status bodies.

The port's gateway routes to the port's own replica table (its module
docstring), so a patch of the reference's ``lookup_replica`` does not
reach it, nor the reverse: the last flow shows it.
"""

import http.client
import importlib
import json
import socket
import threading

import pytest

from _torch_control import NAMES, PACKAGES, held, masked, raised


class _Replica:
    """A fake registered replica: ``submit`` runs ``fn(payload)``."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def submit(self, payload, timeout=None, **kw):
        self.calls += 1
        return self.fn(payload)


class _NoBudget:
    def try_accept(self):
        return False


class _Gateway:
    """One package's gateway on a free port over a fake clientset."""

    def __init__(self, P, monkeypatch):
        self.P = P
        self.mod = importlib.import_module(f"{P.root}.gateway.server")
        self.health = importlib.import_module(f"{P.root}.gateway.health")
        self.serving = importlib.import_module(f"{P.root}.runtime.server")
        self.monkeypatch = monkeypatch
        self.cs = P.FakeClientset()
        self.metrics = importlib.import_module(f"{P.root}.utils.logging").Metrics()
        self.server = self.mod.GatewayServer(self.cs, port=0, metrics=self.metrics)
        self.server.serve_background()

    def close(self):
        self.server.shutdown()
        self.server.server_close()

    def crash(self, payload):
        raise self.serving.ReplicaUnavailable("chaos: replica host died mid-flight")

    def route(self, table):
        """This package's ``lookup_replica`` answers from ``table``."""
        self.monkeypatch.setattr(self.mod, "lookup_replica", table.get)

    def state(self, name, replicas):
        """The TPUServe and its route table seeded with fake replicas (key
        -> _Replica), bypassing discovery: no kubelet in these flows."""
        t = self.P.t
        self.cs.tpuserves().create(t.TPUServe(
            metadata=t.ObjectMeta(name=name),
            spec=t.TPUServeSpec(
                task="echo", checkpoint="v1", replicas=len(replicas),
                batching=t.BatchingPolicy(max_batch_size=8, batch_timeout_ms=5.0,
                                          queue_limit=64)),
        ))
        state = self.server.state_for("default", name)
        for i, key in enumerate(replicas):
            state.table.observe(key, float(i))  # earlier keys route first
        return state

    def retries(self, serve, reason):
        return self.metrics.get_counter("tfk8s_gateway_retries_total", {
            "serve": f"default/{serve}", "tenant": "default", "reason": reason})

    def post(self, path, payload):
        conn = http.client.HTTPConnection("127.0.0.1", self.server.port, timeout=10)
        try:
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, masked(json.loads(resp.read() or b"{}"))
        finally:
            conn.close()


def _with_gateway(flow):
    """``flow(gw)`` on a fresh gateway of the package, closed after."""
    def run(P, monkeypatch):
        gw = _Gateway(P, monkeypatch)
        try:
            return flow(gw)
        finally:
            gw.close()
    run.__qualname__ = flow.__qualname__
    run.__module__ = flow.__module__
    return run


def _dispatch_error(gw, serve):
    """``dispatch`` expected to raise: (its class, the error, or None)."""
    caught = {}

    def go():
        try:
            gw.server.dispatch("default", serve, "default", 1.0, 5.0)
        except Exception as e:  # noqa: BLE001 — recorded and re-raised to ``raised``
            caught["e"] = e
            raise

    return raised(gw.P, go), caught.get("e")


# -- dispatch recovery -------------------------------------------------------


@_with_gateway
def _midflight_crash(gw):
    dead, live = _Replica(gw.crash), _Replica(lambda p: {"echo": p})
    gw.route({"default/r-dead": dead, "default/r-live": live})
    state = gw.state("reroute", ["default/r-dead", "default/r-live"])
    out = gw.server.dispatch("default", "reroute", "default", 7.0, 5.0)
    return {"out": out, "calls": (dead.calls, live.calls),
            "transport_retries": gw.retries("reroute", "transport"),
            # the crash fed the health machine
            "dead_health": state.table.health_state("default/r-dead"),
            "live_health": state.table.health_state("default/r-live")}


@pytest.mark.parametrize("name", NAMES)
def test_midflight_crash_reroutes_to_survivor(name, monkeypatch):
    rec = held(_midflight_crash, name, monkeypatch)
    H = importlib.import_module(f"{PACKAGES[name].root}.gateway.health")
    assert rec == {"out": {"echo": 7.0}, "calls": (1, 1), "transport_retries": 1.0,
                   "dead_health": H.SUSPECT, "live_health": H.HEALTHY}


@_with_gateway
def _budget_exhausted(gw):
    dead = _Replica(gw.crash)
    gw.route({"default/r-dead": dead})
    gw.state("budget", ["default/r-dead"]).retry_budget = _NoBudget()
    cls, err = _dispatch_error(gw, "budget")
    return {"raised": cls, "message": str(err), "tried": err.tried, "calls": dead.calls}


@pytest.mark.parametrize("name", NAMES)
def test_retry_budget_exhaustion_is_typed_with_tried(name, monkeypatch):
    rec = held(_budget_exhausted, name, monkeypatch)
    assert rec["raised"] == "tfk8s_tpu.runtime.server.ReplicaUnavailable"
    assert "retry budget exhausted" in rec["message"]
    # the budget denied any second attempt
    assert rec["calls"] == 1 and rec["tried"] == ["default/r-dead"]


@_with_gateway
def _retry_cap(gw):
    a, b = _Replica(gw.crash), _Replica(gw.crash)
    gw.route({"default/r-a": a, "default/r-b": b})
    gw.state("cap", ["default/r-a", "default/r-b"])
    cls, err = _dispatch_error(gw, "cap")
    return {"raised": cls, "calls": (a.calls, b.calls), "tried": err.tried,
            "cap": gw.mod.MAX_DISPATCH_RETRIES,
            "transport_retries": gw.retries("cap", "transport")}


@pytest.mark.parametrize("name", NAMES)
def test_retry_cap_bounds_attempts(name, monkeypatch):
    rec = held(_retry_cap, name, monkeypatch)
    cap = rec["cap"]
    assert rec["raised"] == "tfk8s_tpu.runtime.server.ReplicaUnavailable"
    assert sum(rec["calls"]) == len(rec["tried"]) == cap + 1
    assert set(rec["tried"]) == {"default/r-a", "default/r-b"}
    assert rec["transport_retries"] == cap


@_with_gateway
def _vanished(gw):
    live = _Replica(lambda p: {"echo": p})
    # r-gone has a route-table entry but NO registry entry: the in-flight
    # request discovers the silent removal
    gw.route({"default/r-live": live})
    state = gw.state("gone", ["default/r-gone", "default/r-live"])
    out = gw.server.dispatch("default", "gone", "default", 3.0, 5.0)
    return {"out": out, "calls": live.calls,
            "removed": gw.metrics.get_counter("tfk8s_gateway_replica_removed_total", {
                "serve": "default/gone", "reason": "ejected"}),
            "gone_health": state.table.health_state("default/r-gone")}


@pytest.mark.parametrize("name", NAMES)
def test_vanished_replica_counts_removal_and_reroutes(name, monkeypatch):
    assert held(_vanished, name, monkeypatch) == {
        "out": {"echo": 3.0}, "calls": 1, "removed": 1.0, "gone_health": None}


# -- wire envelopes ----------------------------------------------------------


@_with_gateway
def _deadline_504(gw):
    def die(payload):
        raise gw.serving.DeadlineExceeded("deadline died on the replica")

    slow = _Replica(die)
    gw.route({"default/r-slow": slow})
    gw.state("slow", ["default/r-slow"])
    return gw.post("/v1/serve/default/slow", {"payload": 1.0, "timeoutS": 5.0})


@pytest.mark.parametrize("name", NAMES)
def test_504_names_tried_replicas_in_details(name, monkeypatch):
    """Deadline exhaustion mid-dispatch is a typed 504 whose Status details
    name the replicas tried."""
    status, body = held(_deadline_504, name, monkeypatch)
    assert status == 504
    assert body["reason"] == "DeadlineExceeded"
    assert body["details"]["triedReplicas"] == ["default/r-slow"]


@_with_gateway
def _budget_503(gw):
    dead = _Replica(gw.crash)
    gw.route({"default/r-dead": dead})
    gw.state("dead", ["default/r-dead"]).retry_budget = _NoBudget()
    return gw.post("/v1/serve/default/dead", {"payload": 1.0, "timeoutS": 5.0})


@pytest.mark.parametrize("name", NAMES)
def test_503_budget_exhaustion_names_tried_replicas(name, monkeypatch):
    status, body = held(_budget_503, name, monkeypatch)
    assert status == 503
    assert body["reason"] == "Unavailable"
    assert body["details"]["triedReplicas"] == ["default/r-dead"]


# -- the client's reconnect hygiene ------------------------------------------


class _FakeGateway:
    """Raw-socket stand-in that garbles the FIRST connection's first
    response frame (bad Content-Length, stale bytes left on the wire) and
    serves valid frames on every later connection and request."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self.accepted = 0
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.accepted += 1
            threading.Thread(target=self._serve_conn, args=(conn, self.accepted == 1),
                             daemon=True).start()

    def _serve_conn(self, conn, garble):
        reader = conn.makefile("rb")
        try:
            while True:
                if not reader.readline():
                    return
                clen = 0
                while True:
                    h = reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    if h.lower().startswith(b"content-length"):
                        clen = int(h.split(b":")[1])
                reader.read(clen)
                if garble:
                    garble = False
                    # the connection stays OPEN with unread junk queued: a
                    # client that keeps the socket hands these bytes to its
                    # NEXT request as the status line
                    conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: banana\r\n\r\nSTALEBYTES")
                    continue
                body = json.dumps({"result": {"ok": True}}).encode()
                conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n\r\n%s"
                             % (len(body), body))
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self.sock.close()


def _garbled(P):
    GatewayClient = importlib.import_module(f"{P.root}.gateway.client").GatewayClient
    fake = _FakeGateway()
    client = GatewayClient(f"http://127.0.0.1:{fake.port}", "s")
    try:
        first = client.request(1.0, timeout=5)
        after_first = fake.accepted
        second = client.request(2.0, timeout=5)
        return {"replies": [first, second], "accepted": [after_first, fake.accepted]}
    finally:
        client.close()
        fake.close()


@pytest.mark.parametrize("name", NAMES)
def test_garbled_frame_drops_warm_socket(name):
    """A response the client cannot frame leaves unread bytes on its warm
    socket: it must reconnect, and once healthy pipeline again on one."""
    assert held(_garbled, name) == {"replies": [{"ok": True}] * 2, "accepted": [2, 2]}


def _unreachable(P):
    GatewayClient = importlib.import_module(f"{P.root}.gateway.client").GatewayClient
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens here now
    client = GatewayClient(f"http://127.0.0.1:{port}", "s")
    errors = []

    def go():
        try:
            client.request(1.0, timeout=5)
        except Exception as e:  # noqa: BLE001 — recorded, then re-raised to ``raised``
            errors.append(str(e))
            raise

    try:
        return {"raised": raised(P, go), "unreachable": "unreachable" in errors[0]}
    finally:
        client.close()


@pytest.mark.parametrize("name", NAMES)
def test_unreachable_gateway_is_typed_after_bounded_retries(name):
    assert held(_unreachable, name) == {
        "raised": "tfk8s_tpu.client.store.Unavailable", "unreachable": True}


# -- each gateway routes to its own package's table ---------------------------


@pytest.mark.parametrize("name", NAMES)
def test_a_patch_of_the_other_packages_table_does_not_reach_the_gateway(name, monkeypatch):
    """A replica registered only in the OTHER package's table is not found
    by this package's gateway: the route-table entry is discovered vanished
    and the request ends typed ``Unavailable`` with the other table's
    replica never called."""
    P = PACKAGES[name]
    other = PACKAGES["port" if name == "reference" else "reference"]
    live = _Replica(lambda p: {"echo": p})
    monkeypatch.setattr(importlib.import_module(f"{other.root}.gateway.server"),
                        "lookup_replica", {"default/r-live": live}.get)
    gw = _Gateway(P, monkeypatch)
    try:
        gw.state("cross", ["default/r-live"])
        got = raised(P, gw.server.dispatch, "default", "cross", "default", 1.0, 0.3)
        assert got == "tfk8s_tpu.client.store.Unavailable"
        assert live.calls == 0
        assert gw.metrics.get_counter("tfk8s_gateway_replica_removed_total", {
            "serve": "default/cross", "reason": "ejected"}) == 1.0
    finally:
        gw.close()
