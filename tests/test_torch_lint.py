"""The repo's source checks run over the port.

``tools/lint``'s six checkers scope themselves to ``tfk8s_tpu/`` (their
``relevant`` scopes, the typed-errors and seeded-determinism file lists,
and the lock names the lock-order pins use). Here the port's modules are
loaded with their paths written as the reference's (``tfk8s_tpu_torch/x``
as ``tfk8s_tpu/x``), so every checker sees the port as it sees the
reference, ``tools/`` unedited; findings are keyed back to the port's
paths and matched against the port's own suppressions,
``tests/torch_lint_suppressions.txt``. The gate is the reference's: no
finding, no format error, no unused suppression, every suppression with
its reason.

Beside it: the metric-name lint over the port's sources and over the text
the port's ``/metrics`` serves, and the malformed-input corpus of
``tfk8s_tpu_torch/tools/sanitize_smoke.py`` against the port's plainly
built native cores (the sanitized runs of that tool are by hand, as the
reference's are ``slow``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import threading
import urllib.request

import pytest

from tools.check_metric_names import lint_exposition, lint_paths
from tools.lint.checkers import all_checkers
from tools.lint.checkers.lock_order import PINNED_EDGES, LockOrderChecker
from tools.lint.checkers.seeded_determinism import SCOPE_PREFIXES
from tools.lint.checkers.typed_errors import SCOPE, TypedErrorsChecker
from tools.lint.driver import LintResult, load_modules, load_suppressions

from _torch_control import PACKAGES, make_job, wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT, REF = "tfk8s_tpu_torch/", "tfk8s_tpu/"
SUPPRESSIONS = os.path.join(REPO, "tests", "torch_lint_suppressions.txt")


def port_modules():
    """The port's modules parsed once, their paths written as the
    reference's; and the parse errors."""
    modules, errors = load_modules([os.path.join(REPO, PORT)])
    for m in modules:
        assert m.relpath.startswith(PORT), m.relpath
        m.relpath = REF + m.relpath[len(PORT):]
    return modules, errors


def _as_port(finding):
    rel = finding.relpath
    return dataclasses.replace(finding, relpath=PORT + rel[len(REF):]) if rel.startswith(REF) \
        else finding


def run_port_lint(suppressions_path=SUPPRESSIONS, checkers=None) -> LintResult:
    """``tools.lint.driver.run_lint`` over the port: each checker on the
    modules its scope takes, findings keyed by the port's paths."""
    result = LintResult()
    modules, errors = port_modules()
    result.errors.extend(errors)
    sups, sup_errors = load_suppressions(suppressions_path)
    result.errors.extend(sup_errors)
    for checker in checkers if checkers is not None else all_checkers():
        for finding in checker.check([m for m in modules if checker.relevant(m.relpath)]):
            finding = _as_port(finding)
            hit = next((s for s in sups if s.matches(finding.key)), None)
            if hit is None:
                result.findings.append(finding)
            else:
                hit.used = True
                result.suppressed.append((finding, hit))
    result.unused_suppressions = [s for s in sups if not s.used]
    result.findings.sort(key=lambda f: (f.relpath, f.line, f.checker))
    return result


# -- the gate ----------------------------------------------------------------


def test_the_port_lints_clean_with_all_six_checkers():
    assert len(all_checkers()) == 6
    result = run_port_lint()
    detail = "\n".join(f.render() for f in result.findings)
    assert result.ok, f"lint findings on the port:\n{detail}\n{result.errors}"
    assert result.clean, "unused suppressions: " + ", ".join(
        s.pattern for s in result.unused_suppressions)
    # every suppression names a port file
    assert all(f.relpath.startswith(PORT) for f, _ in result.suppressed)


def test_every_port_suppression_carries_a_reason():
    sups, errors = load_suppressions(SUPPRESSIONS)
    assert not errors and sups
    assert all(s.reason for s in sups)
    assert all(s.pattern.split(":")[1].startswith(PORT) for s in sups)


def test_an_unused_port_suppression_blocks_clean(tmp_path):
    path = tmp_path / "sups.txt"
    with open(SUPPRESSIONS, encoding="utf-8") as f:
        path.write_text(f.read() + "typed-errors:tfk8s_tpu_torch/ghost.py:f:raise:X  # stale\n")
    result = run_port_lint(str(path))
    assert result.ok and not result.clean
    assert [s.pattern for s in result.unused_suppressions] == [
        "typed-errors:tfk8s_tpu_torch/ghost.py:f:raise:X"]


def test_lock_order_on_the_port_is_acyclic_with_every_pin_observed():
    """The port's lock graph is acyclic and the reference's documented pins
    (the store's kind -> commit order) are observed on the port's store:
    no ``cycle:`` and no rotted ``unobserved:`` pin."""
    assert PINNED_EDGES
    modules, _ = port_modules()
    assert list(LockOrderChecker().check(modules)) == []


def test_the_checkers_scopes_reach_the_port():
    """Each scope the checkers list names files the port has, so the path
    mapping leaves no checker looking at nothing."""
    relpaths = {m.relpath for m in port_modules()[0]}
    assert {p for p in SCOPE if p.startswith(REF)} <= relpaths
    for prefix in (p for p in SCOPE_PREFIXES if p.startswith(REF)):
        assert any(r.startswith(prefix) for r in relpaths), prefix
    for checker in all_checkers():
        assert any(checker.relevant(r) for r in relpaths), checker.name


def test_typed_errors_resolves_the_remote_clients_error_factory():
    """``raise _map_error(...)`` in the port's ``client/remote.py`` is typed
    because every return of the factory constructs a ``StoreError``."""
    findings = list(TypedErrorsChecker().check(port_modules()[0]))
    assert not any(f.detail == "raise:_map_error" for f in findings)


def test_sampling_params_has_one_definition_in_the_port():
    """The serving path parses a request's ``sampling`` block through
    ``api.types.SamplingParams``, as the reference's does: a second copy
    in ``runtime/server.py`` raised its ``ValueError``s inside the
    typed-errors scope."""
    P = PACKAGES["port"]
    serving = importlib.import_module(f"{P.root}.runtime.server")
    assert not hasattr(serving, "SamplingParams")
    assert serving._parse_sampling({"temperature": 0.5, "topK": 3}) == (0.5, 3, 1.0, 0)
    with pytest.raises(serving.InvalidRequest, match="top_p must be in"):
        serving._parse_sampling({"temperature": 0.5, "top_p": 0})


# -- metric names --------------------------------------------------------------

# the counters the hot-path and gateway-fault flows hold, by exported name
HOT_PATH = ("tfk8s_watch_coalesced_total", "tfk8s_status_patches_skipped_total",
            "tfk8s_gateway_retries_total", "tfk8s_gateway_replica_removed_total",
            "tfk8s_gateway_ejections_total", "tfk8s_gateway_requests_total")


def test_the_port_metric_names_are_coherent():
    problems = lint_paths([os.path.join(REPO, PORT)])
    assert problems == [], "\n".join(problems)


def test_the_port_scope_covers_the_hot_path_counters():
    seen = dict.fromkeys(HOT_PATH, False)
    for dirpath, _dirs, names in os.walk(os.path.join(REPO, PORT)):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(dirpath, n), encoding="utf-8") as f:
                    src = f.read()
                for name in seen:
                    seen[name] = seen[name] or f'"{name}"' in src
    assert all(seen.values()), [n for n, s in seen.items() if not s]


def _block(env, stop):
    stop.wait(0.2)


def test_the_port_metrics_endpoint_serves_lint_clean_exposition():
    """A job to ``Succeeded`` on the port's in-process ``Server``, a slow
    watcher of its store and a skipped status write; then ``/metrics`` over
    HTTP: every line lints clean and the hot-path counters are exposed."""
    P = PACKAGES["port"]
    P.registry.register("tlint.block", _block)
    frozen = importlib.import_module(f"{P.root}.api.frozen")
    server = P.Server(P.Options(workers=1))
    stop = threading.Event()
    server.run(stop, block=False)
    try:
        cs = server.clientset
        cs.tpujobs().create(make_job(P, "lint", "tlint.block"))
        wait(lambda: any(c.type.value == "Succeeded" and c.status
                         for c in cs.tpujobs().get("lint").status.conditions), 60)
        w = server.store.watch("TPUJob", queue_limit=1)
        cur = frozen.thaw(server.store.get("TPUJob", "default", "lint"))
        for _ in range(3):
            cur.status.gang_restarts += 1
            cur = server.store.update_status(cur)
        server.store.stop_watch(w)
        job = P.serde.roundtrip(cs.tpujobs().get("lint"))
        job._status_baseline = P.serde.to_wire(job.status)
        assert server.controller._write_status(job)
        port = server.start_metrics_server(0)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            text = resp.read().decode()
    finally:
        stop.set()
        server.shutdown()
        P.registry._REGISTRY.pop("tlint.block", None)
    assert lint_exposition(text) == []
    exposed = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
               if line and not line.startswith("#")}
    assert {"tpujob_succeeded_total", "tfk8s_watch_coalesced_total",
            "tfk8s_status_patches_skipped_total"} <= exposed, sorted(exposed)


# -- the sanitizer corpus on the plainly built cores ---------------------------


def _smoke(core, tmp_path, capsys):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the port's native cores")
    tool = importlib.import_module("tfk8s_tpu_torch.tools.sanitize_smoke")
    return getattr(tool, f"smoke_{core}")(str(tmp_path)), capsys.readouterr().out


def test_the_record_core_refuses_the_malformed_corpus_typed(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("TFK8S_NATIVE_SANITIZE", raising=False)
    monkeypatch.delenv("TFK8S_PURE_PY", raising=False)
    from tfk8s_tpu_torch.data import _native

    if _native.load() is None:
        pytest.skip("the record core did not build here")
    failures, out = _smoke("recordio", tmp_path, capsys)
    assert failures == 0, out
    assert "recordio:" in out and "corpus cases, 0 failure(s)" in out, out


def test_the_image_core_refuses_the_malformed_corpus(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("TFK8S_NATIVE_SANITIZE", raising=False)
    monkeypatch.delenv("TFK8S_PURE_PY", raising=False)
    pytest.importorskip("PIL")
    from tfk8s_tpu_torch.data.images import _native_decode as nd

    if nd.load() is None:
        pytest.skip("the image core did not build here (no jpeglib.h)")
    failures, out = _smoke("imagecore", tmp_path, capsys)
    assert failures == 0, out
    assert "imagecore:" in out and "corpus cases, 0 failure(s)" in out, out


def test_the_tool_refuses_to_run_unsanitized(monkeypatch, capsys):
    monkeypatch.delenv("TFK8S_NATIVE_SANITIZE", raising=False)
    tool = importlib.import_module("tfk8s_tpu_torch.tools.sanitize_smoke")
    assert tool.main([]) == 2
    assert "TFK8S_NATIVE_SANITIZE" in capsys.readouterr().err


def test_the_corpus_matches_the_references():
    """The port's corpus is the reference tool's, case for case."""
    ref = importlib.import_module("tools.sanitize_smoke")
    port = importlib.import_module("tfk8s_tpu_torch.tools.sanitize_smoke")
    valid = json.dumps({"seed": list(range(300))}).encode()
    assert port._mutations(valid) == ref._mutations(valid)
