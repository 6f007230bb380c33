"""leolint for the port (``repro_torch.analysis``): the cases of
``tests/test_leolint.py`` with PyTorch in place of JAX.  Each pass fires on
its seeded fixture violation (``tests/analysis_fixtures_torch/``):
locklint on torch's host-device sync points under a lock, and not on an
eager op, which only enqueues work; jitlint on ``torch.compile``'d
functions.  Waivers suppress, reason-less waivers are reported, and the
port's tree is clean under ``--strict``."""

import os
import subprocess
import sys

import pytest

from repro_torch.analysis import run_passes
from repro_torch.analysis.__main__ import main as leolint_main

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
FIXTURES = os.path.join(os.path.dirname(__file__), "analysis_fixtures_torch")
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


def _fx(name):
    return os.path.join(FIXTURES, name)


def _live(findings, pass_id):
    return [f for f in findings if f.pass_id == pass_id and not f.waived]


def _line_of(name, text):
    with open(_fx(name)) as fh:
        return next(i for i, l in enumerate(fh, 1) if text in l)


def _lock_findings():
    findings, _ = run_passes([_fx("fixture_lock.py")], ["locklint"])
    return _live(findings, "locklint")


# ----------------------------------------------------------------------
# locklint
# ----------------------------------------------------------------------
@pytest.mark.parametrize("call,attr", [
    ("x.item()", "item"), ("x.tolist()", "tolist"), ("x.cpu()", "cpu"),
    ("torch.cuda.synchronize()", "synchronize"),
    ("self._stream.synchronize()", "synchronize"),
    ("self._event.synchronize()", "synchronize"),
    ("self._stream.wait_stream(other)", "wait_stream"),
    ("self._stream.wait_event(self._event)", "wait_event"),
    ("mm.flush()", "flush")])
def test_locklint_flags_each_sync_point_under_lock(call, attr):
    line = _line_of("fixture_lock.py", call + " ")
    hits = [f for f in _lock_findings() if f.line == line]
    assert hits, [f.render() for f in _lock_findings()]
    assert f"`.{attr}()`" in hits[0].message
    assert "stalls every worker" in hits[0].message


def test_locklint_flags_compiled_call_fence_and_wait_under_lock():
    live = _lock_findings()
    assert any("compiled" in f.message and "_compiled_helper" in f.message
               for f in live), [f.message for f in live]
    assert any("ingest_fence" in f.message for f in live)
    waits = [f for f in live if ".result()" in f.message]
    assert waits and "deadlock" in waits[0].message


def test_locklint_leaves_eager_ops_and_host_work_alone():
    live = _lock_findings()
    for text in ("torch.stack([x, x])", "self._futs.append((key, val))"):
        line = _line_of("fixture_lock.py", text)
        assert not [f for f in live if f.line == line], text


def test_locklint_flags_indirect_sync_at_call_site():
    live = _lock_findings()
    hits = [f for f in live if "_helper" in f.message
            and "_compiled_helper" not in f.message]
    assert hits, [f.message for f in live]
    assert hits[0].line == _line_of("fixture_lock.py", "self._helper(x)")
    assert "`.cpu()`" in hits[0].message


def test_locklint_detects_lock_order_cycle():
    cyc = [f for f in _lock_findings() if "cycle" in f.message]
    assert cyc and "ABBA" in cyc[0].message


# ----------------------------------------------------------------------
# threadlint
# ----------------------------------------------------------------------
def test_threadlint_flags_worker_reaching_decode_only():
    findings, _ = run_passes([_fx("fixture_thread.py")], ["threadlint"])
    live = _live(findings, "threadlint")
    assert any("ingest_worker" in f.message and "scatter" in f.message
               for f in live), [f.message for f in live]
    assert any("indirect_worker" in f.message and "_place" in f.message
               for f in live)
    assert any("_submitted" in f.message for f in live)
    assert not any("clean_worker" in f.message for f in live)


# ----------------------------------------------------------------------
# billlint
# ----------------------------------------------------------------------
def test_billlint_flags_unbilled_write_and_read():
    findings, _ = run_passes([_fx("fixture_bill.py")], ["billlint"])
    live = _live(findings, "billlint")
    assert any("bad_write" in f.message for f in live)
    assert any("bad_sidecar_write" in f.message for f in live)
    assert any("bad_read" in f.message for f in live)
    assert not any("good_write" in f.message for f in live)
    assert not any("good_read" in f.message for f in live)


def test_billlint_flags_unknown_transfer_kind():
    findings, _ = run_passes([_fx("fixture_bill.py")], ["billlint"])
    assert any("mystery_bytes" in f.message
               for f in _live(findings, "billlint"))


# ----------------------------------------------------------------------
# jitlint (torch.compile roots)
# ----------------------------------------------------------------------
def test_jitlint_flags_impure_compiled_functions():
    findings, _ = run_passes([_fx("fixture_jit.py")], ["jitlint"])
    live = _live(findings, "jitlint")
    msgs = [f.message for f in live]
    # decorated with torch.compile
    assert any("time.perf_counter" in m and "clock_in_compiled" in m
               for m in msgs), msgs
    # torch.compile(mode=...) as a decorator factory
    assert any("RNG" in m and "rng_in_compiled" in m for m in msgs)
    # functools.partial(torch.compile, ...)
    assert any("lock" in m and "lock_in_compiled" in m for m in msgs)
    # `from torch import compile as tcompile`
    assert any("time.time" in m and "wall_clock_in_compiled" in m
               for m in msgs)
    # mutation reached through a callee of the compiled root
    assert any("self.calls" in m for m in msgs)
    # factory pattern: torch.compile(make_step(...)) roots the nested def
    assert any("step.count" in m for m in msgs)
    # the pure lambda root and the eager function stay quiet
    assert not any("tanh" in m or "not_compiled" in m for m in msgs)


def test_jitlint_finds_no_compiled_function_in_the_port():
    findings, _ = run_passes([PORT], ["jitlint"])
    assert findings == []


# ----------------------------------------------------------------------
# waivers
# ----------------------------------------------------------------------
def test_waiver_with_reason_suppresses_finding():
    findings, _ = run_passes([_fx("fixture_waive.py")], ["locklint"])
    waived = [f for f in findings if f.waived]
    assert waived and "decode thread only touches this path" \
        in waived[0].reason
    live = _live(findings, "locklint")
    assert len(live) == 1 and "`.cpu()`" in live[0].message
    assert any(f.pass_id == "waiver" and "reason" in f.message
               for f in findings)


def test_waiver_on_def_line_covers_whole_function():
    path = os.path.join(PORT, "serving", "offload.py")
    with open(path) as fh:
        src_lines = fh.readlines()
    start = next(i for i, l in enumerate(src_lines, 1)
                 if l.lstrip().startswith("def fetch_chunks_pooled"))
    end = next((i for i, l in enumerate(src_lines[start:], start + 1)
                if l.startswith("    def ")), len(src_lines))
    findings, _ = run_passes([PORT], ["locklint"])
    pooled = [f for f in findings if f.path.endswith("offload.py")
              and start <= f.line < end]
    # the B3 slab update under the store lock, each one reasoned
    assert pooled and all(f.waived for f in pooled)
    assert all("tolist" in f.message and "tolist" in f.reason
               for f in pooled)


# ----------------------------------------------------------------------
# CLI / the port's tree
# ----------------------------------------------------------------------
def test_cli_strict_clean_on_the_port():
    """Acceptance gate: the port has zero unexplained findings."""
    assert leolint_main(["--strict", PORT]) == 0
    findings, _ = run_passes([PORT])
    assert findings and all(f.waived and f.reason for f in findings)


def test_cli_strict_subprocess_with_the_default_path():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--strict"], env=env, cwd=os.path.abspath(ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stderr


def test_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(
        "import threading\n"
        "class S:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def f(self, x):\n"
        "        with self._lock:\n"
        "            return x.item()\n")
    assert leolint_main([str(bad)]) == 1
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        str(bad)], env=env, capture_output=True, timeout=300)
    assert r.returncode == 1


def test_unknown_pass_rejected():
    with pytest.raises(SystemExit):
        leolint_main(["--passes", "nosuchpass", PORT])


_PROBE = """
import sys
import repro_torch.analysis, repro_torch.analysis.__main__
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "repro"
             or k.startswith("repro."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_the_checker_loads_no_jax_and_no_repro():
    """The copy imports the standard library only, as the reference's
    does (``import repro_torch`` itself brings torch)."""
    env = {**os.environ, "PYTHONPATH": os.path.abspath(SRC)}
    r = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
