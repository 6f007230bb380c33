"""The port's copies of the analytic latency simulator
(``repro_torch.serving.simulator``) and of the desert-rate / chunk-size
policy (``repro_torch.core.desert``): framework-free modules, so they must
return the reference's values exactly.

Ported: ``tests/test_simulator_properties.py`` (every test), the desert
tests of ``tests/test_desert_tiers.py`` and
``tests/test_overload.py::test_simulator_trace_goodput_matches_queueing_logic``.
Then each function of both modules against ``repro``'s on a grid of
inputs, equal to the last bit.  The hardware constants (``HWCfg``) are the
paper testbed's (RTX-4090, PCIe 4.0, NVMe): an analytic model, not a
measurement of any card.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as j_get_config
from repro.core import desert as jdesert
from repro.serving import simulator as jsim
from repro.serving.trace import Arrival as JArrival
from repro_torch.configs import get_config
from repro_torch.core import desert
from repro_torch.core.desert import (chunk_size_schedule, desert_rate,
                                     eval_cost, optimal_chunk_count,
                                     optimal_chunk_size)
from repro_torch.serving import simulator as sim
from repro_torch.serving.simulator import (HWCfg, ServeCfg, compare_policies,
                                           simulate_decode, simulate_request,
                                           simulate_trace_goodput)
from repro_torch.serving.trace import Arrival

CFG = get_config("longchat-7b-32k")
JCFG = j_get_config("longchat-7b-32k")


# ---------------------------------------------------------------------------
# simulator properties (tests/test_simulator_properties.py)
# ---------------------------------------------------------------------------


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 8), st.sampled_from([2048, 8192, 16384]))
def test_leoam_never_slower_than_baselines(batch, prompt):
    res = compare_policies(CFG, ServeCfg(batch=batch, prompt=prompt,
                                         output=32))
    assert res["leoam_all"]["total_s"] <= res["h2o"]["total_s"] + 1e-9
    assert res["leoam_all"]["total_s"] <= res["full"]["total_s"] + 1e-9


@settings(max_examples=10, deadline=None)
@given(st.sampled_from([2048, 8192, 32768]))
def test_latency_monotone_in_context(prompt):
    a = simulate_request(CFG, ServeCfg(batch=2, prompt=prompt, output=32),
                         HWCfg(), "leoam_all")
    b = simulate_request(CFG, ServeCfg(batch=2, prompt=prompt * 2, output=32),
                         HWCfg(), "leoam_all")
    assert b["total_s"] >= a["total_s"]


@settings(max_examples=10, deadline=None)
@given(st.floats(0.02, 0.5))
def test_decode_cost_monotone_in_budget(rate):
    lo = simulate_decode(CFG, ServeCfg(batch=2, prompt=8192,
                                       importance_rate=rate), HWCfg(),
                         "leoam_all")
    hi = simulate_decode(CFG, ServeCfg(batch=2, prompt=8192,
                                       importance_rate=min(1.0, rate * 2)),
                         HWCfg(), "leoam_all")
    assert hi.total_s >= lo.total_s - 1e-9


def test_faster_disk_helps_baseline_more():
    """LeoAM's advantage shrinks as the disk gets faster."""
    slow = compare_policies(CFG, ServeCfg(batch=4, prompt=8192, output=64),
                            HWCfg(disk_bw=3e9))
    fast = compare_policies(CFG, ServeCfg(batch=4, prompt=8192, output=64),
                            HWCfg(disk_bw=30e9))
    adv_slow = slow["h2o"]["total_s"] / slow["leoam_all"]["total_s"]
    adv_fast = fast["h2o"]["total_s"] / fast["leoam_all"]["total_s"]
    assert adv_slow > adv_fast


# ---------------------------------------------------------------------------
# desert rate and the Eq.(2) chunk-size policy (tests/test_desert_tiers.py)
# ---------------------------------------------------------------------------


def test_eval_cost_token_level_limit():
    assert eval_cost(1024, 1024, 0.1) == 1024.0


def test_dense_layers_get_finer_chunks():
    """Insight 2: high ρ (dense early layers) → more initial chunks."""
    assert optimal_chunk_count(4096, 0.5) >= optimal_chunk_count(4096, 0.05)
    assert optimal_chunk_size(4096, 0.5) <= optimal_chunk_size(4096, 0.05)


def test_chunk_size_schedule_shape():
    sched = chunk_size_schedule(32768, 32, early_layers=2)
    assert len(sched) == 32
    assert sched[0] <= sched[-1]
    assert all(s & (s - 1) == 0 for s in sched)   # powers of two


def test_desert_rate_on_planted():
    s = np.zeros(1024)
    s[100:110] = 1.0
    s[800:820] = 2.0
    rate = desert_rate(s + 1e-9 * np.arange(1024), chunk=16, rate=0.03)
    assert rate > 0.9


# ---------------------------------------------------------------------------
# trace goodput (tests/test_overload.py)
# ---------------------------------------------------------------------------


def test_simulator_trace_goodput_matches_queueing_logic():
    """A plain FCFS replay: generous deadlines give goodput 1, impossible
    ones 0, and two servers drain a simultaneous burst sooner."""
    cfg = get_config("longchat-7b-32k", smoke=True)
    arr = [Arrival(t=0.0, prompt_len=64, max_new=4, deadline_s=None)
           for _ in range(4)]
    hw, scfg = HWCfg(), ServeCfg(output=4)
    r = simulate_trace_goodput(cfg, scfg, hw, arr)
    assert r["goodput"] == 1.0 and r["requests"] == 4.0
    tight = [dataclasses.replace(a, deadline_s=1e-12) for a in arr]
    assert simulate_trace_goodput(cfg, scfg, hw, tight)["goodput"] == 0.0
    m1 = simulate_trace_goodput(cfg, scfg, hw, arr)["makespan_s"]
    m2 = simulate_trace_goodput(cfg, scfg, hw, arr, servers=2)["makespan_s"]
    assert m2 < m1


# ---------------------------------------------------------------------------
# the copies against repro, exactly
# ---------------------------------------------------------------------------


def _as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("policy", sim.POLICIES)
@pytest.mark.parametrize("batch,prompt,rate", [
    (1, 2048, 0.1), (4, 8192, 0.05), (2, 32768, 0.3)])
def test_simulator_equals_reference(policy, batch, prompt, rate):
    hws = [HWCfg(), HWCfg(disk_bw=30e9)]
    jhws = [jsim.HWCfg(), jsim.HWCfg(disk_bw=30e9)]
    for hw, jhw in zip(hws, jhws):
        scfg = ServeCfg(batch=batch, prompt=prompt, output=16,
                        importance_rate=rate)
        jscfg = jsim.ServeCfg(batch=batch, prompt=prompt, output=16,
                              importance_rate=rate)
        assert _as_dict(scfg) == _as_dict(jscfg) and \
            _as_dict(hw) == _as_dict(jhw)
        assert simulate_request(CFG, scfg, hw, policy) == \
            jsim.simulate_request(JCFG, jscfg, jhw, policy)
        assert _as_dict(simulate_decode(CFG, scfg, hw, policy)) == \
            _as_dict(jsim.simulate_decode(JCFG, jscfg, jhw, policy))
        assert [_as_dict(c) for c in sim.decode_step_costs(
            CFG, scfg, hw, policy)] == [_as_dict(c) for c in
                                        jsim.decode_step_costs(
                                            JCFG, jscfg, jhw, policy)]
        for h in (0.0, 0.25, 1.0):
            assert sim.prefill_time_prefix(CFG, scfg, hw, h) == \
                jsim.prefill_time_prefix(JCFG, jscfg, jhw, h)


def test_trace_goodput_equals_reference():
    rng = np.random.RandomState(0)
    rows = [(float(t), int(n), int(m), d) for t, n, m, d in zip(
        np.cumsum(rng.exponential(0.5, 12)), rng.choice([64, 512, 4096], 12),
        rng.choice([4, 16], 12), [None, 1.0, 30.0] * 4)]
    arr = [Arrival(t=t, prompt_len=n, max_new=m, deadline_s=d)
           for t, n, m, d in rows]
    jarr = [JArrival(t=t, prompt_len=n, max_new=m, deadline_s=d)
            for t, n, m, d in rows]
    for servers in (1, 3):
        assert simulate_trace_goodput(CFG, ServeCfg(), HWCfg(), arr,
                                      servers=servers) == \
            jsim.simulate_trace_goodput(JCFG, jsim.ServeCfg(), jsim.HWCfg(),
                                        jarr, servers=servers)


@pytest.mark.parametrize("n", [256, 4096, 32768])
@pytest.mark.parametrize("rho", [0.02, 0.1, 0.5])
def test_desert_equals_reference(n, rho):
    for m in (1, 8, 64, n):
        assert eval_cost(n, m, rho) == jdesert.eval_cost(n, m, rho)
    assert optimal_chunk_count(n, rho) == jdesert.optimal_chunk_count(n, rho)
    assert optimal_chunk_size(n, rho) == jdesert.optimal_chunk_size(n, rho)
    assert sim.optimal_m(n, rho) == jsim.optimal_m(n, rho)
    np.testing.assert_array_equal(chunk_size_schedule(n, 32),
                                  jdesert.chunk_size_schedule(n, 32))
    np.testing.assert_array_equal(desert.layer_density_schedule(32),
                                  jdesert.layer_density_schedule(32))
    s = np.random.RandomState(n).rand(n) ** 8
    for chunk in (8, 64):
        assert desert_rate(s, chunk, rho) == jdesert.desert_rate(s, chunk,
                                                                  rho)
