"""One run of one cell: build the cell from ``BENCHMARK.json`` and the files
its names point to, serve its traffic through the program
(``repro_torch``: ``ContinuousBatcher`` over ``BatchedLeoAMEngine``),
measure a window, judge what the window served against the plain
reference, and print one JSON line.

Everything cell-specific is data found by name:

* ``bench/configs/<config>.json``: the model as published, the keys
  changed for the run (``reduced``) and the program's settings (``port``);
* ``bench/traffic/<mix>.json``: the mix, read by ``bench.generator``;
* ``bench/metrics/<metric>.py``: one reader a metric, ``read(rec)``,
  returning a number or None;
* ``bench/checks/<cell>.json``: the limit of each number compared.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# fixed cache directories inside the checkout: only a checkout's first run
# builds or compiles anything
CACHE_DIRS = {"TRITON_CACHE_DIR": ".bench_cache/triton",
              "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
              "CUDA_CACHE_PATH": ".bench_cache/nv"}

# the arch fields a configuration file's published keys set
_ARCH_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
              "num_attention_heads": "n_heads",
              "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
              "vocab_size": "vocab_size", "rope_theta": "rope_theta",
              "rms_norm_eps": "norm_eps",
              "tie_word_embeddings": "tie_embeddings",
              "first_k_dense_replace": "first_dense"}
_MOE_KEYS = {"n_routed_experts": "n_experts", "num_experts_per_tok": "top_k",
             "moe_intermediate_size": "d_ff_expert",
             "n_shared_experts": "n_shared"}
_MLA_KEYS = ("kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim")


def set_env() -> None:
    for var, rel in CACHE_DIRS.items():
        path = ROOT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(names=None) -> List[str]:
    """Top-level module names of JAX or the JAX package among ``names``
    (default: the loaded modules), compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The cell, from its names
# ---------------------------------------------------------------------------


def load_spec(spec_file: Optional[Path] = None) -> Dict:
    """``BENCHMARK.json``, or another file of the same keys (a cell that
    waits in ``bench/pending/`` runs from its own file: the tests, the
    control and the sweep name it; the benchmark's runs never do)."""
    return json.loads(Path(spec_file or ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, spec_file: Optional[Path] = None) -> Dict:
    spec = load_spec(spec_file)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    model = json.loads((ROOT / cfg_entry["file"]).read_text())
    from bench import generator as traffic
    mix = traffic.load_mix(cell["traffic"])

    def listed(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if listed(m) and m["moves"] in e2e_names]
    checks_file = BENCH / "checks" / f"{name}.json"
    checks = json.loads(checks_file.read_text()) if checks_file.exists() \
        else {}
    return {"name": name, "cell": cell, "model": model, "mix": mix,
            "end_to_end": e2e, "per_layer": per_layer, "checks": checks,
            "chips": int(cell["chips"])}


def judge(checks_spec: Dict, numbers: Dict, failed: int) -> tuple:
    """The numbers a cell's checks file compares, each beside its limit,
    and whether the run is correct: every number at or under its limit
    and no measured request failed."""
    checks = {k: {"value": numbers[k], "limit": v["limit"]}
              for k, v in checks_spec.items()}
    correct = bool(checks) and not failed and all(
        c["value"] <= c["limit"] for c in checks.values())
    return checks, correct


def layer_rates(arch) -> List[float]:
    """The share of each layer's rows the configuration has a decode
    round load (LeoAM's importance rate, denser on the early layers)."""
    lc = arch.leoam
    return [lc.early_rate if li < lc.early_layers else lc.importance_rate
            for li in range(arch.n_layers)]


def build_arch(model: Dict):
    """The program's config for a configuration file: the registered
    architecture with every published key the file gives set from it, and
    the file's ``port`` settings (``leoam`` knobs, ``dtype``)."""
    from repro_torch.configs import get_config
    port = model["port"]
    if model.get("rope_scaling") is not None:
        raise ValueError("the program applies no rope_scaling")
    cfg = get_config(port["arch"])
    kw = {f: model[k] for k, f in _ARCH_KEYS.items() if k in model}
    if "intermediate_size" in model:
        kw["d_ff"] = model["intermediate_size"]
        if cfg.d_ff_dense is not None:
            kw["d_ff_dense"] = model["intermediate_size"]
    if cfg.moe is not None:
        if not model.get("norm_topk_prob", True):
            raise ValueError("the program renormalizes the top-k weights")
        kw["moe"] = dataclasses.replace(
            cfg.moe, **{f: model[k] for k, f in _MOE_KEYS.items()})
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, **{k: model[k] for k in _MLA_KEYS})
    if "leoam" in port:
        kw["leoam"] = dataclasses.replace(cfg.leoam, **port["leoam"])
    if "dtype" in port:
        kw["dtype"] = port["dtype"]
    return dataclasses.replace(cfg, **kw)


def load_metric(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# Watching the program: selections, rounds, spans
# ---------------------------------------------------------------------------


class Recorder:
    """Wraps the engine's calls (instance attributes only) to record what
    each round selected, per request and position, which of the selected
    chunks the pool holds as int4 transit payload (and how many of their
    rows), and the shapes of each round's kernel calls; with ``spans`` it
    also opens a ``bench.*`` profiler range around each call into a
    layer.

    A chunk uploaded in a pooled fetch's codec part holds, until its slot
    is allocated again, the int4 round trip of the rows it had then; rows
    appended later land exact.  ``comp`` tracks that per (layer, row,
    chunk) from the pools' ``alloc`` and ``scatter`` calls."""

    def __init__(self, eng, batcher, spans: bool):
        import torch
        self.sels: Dict[int, Dict[int, Dict[int, List[int]]]] = \
            defaultdict(dict)
        self.int4: Dict[int, Dict[int, Dict[int, Dict[int, int]]]] = \
            defaultdict(dict)
        self.comp: Dict[tuple, int] = {}
        self.rounds: List[Dict[str, Any]] = []
        self.admits: List[Dict[str, float]] = []
        self._cur: Dict[int, int] = {}
        self._round: Optional[Dict[str, Any]] = None
        rf = torch.profiler.record_function if spans else None

        def span(name, fn):
            if rf is None:
                return fn

            def wrapped(*a, **k):
                with rf(name):
                    return fn(*a, **k)
            return wrapped

        decode_round = eng.decode_round
        select = eng._select_chunks_batched
        admit = eng._admit

        def rec_round(tokens):
            self._cur = {sid: req.rid
                         for (req, sid, _) in batcher.active.values()}
            lengths = {sid: eng.seqs[sid].length for sid in tokens}
            self._round = {"t0": time.perf_counter(), "B": len(tokens),
                           "lengths": lengths, "layers": {}}
            out = decode_round(tokens)
            self._round["t1"] = time.perf_counter()
            self.rounds.append(self._round)
            return out

        def rec_select(li, layer, q, order, lengths):
            sels, stats = select(li, layer, q, order, lengths)
            chunk = eng.chunk
            live = 0
            for sid, L in zip(order, lengths):
                sel = [int(c) for c in sels[sid]]
                self.sels[self._cur[sid]].setdefault(int(L), {})[li] = sel
                live += sum(max(0, min(chunk, int(L) - c * chunk))
                            for c in sel)
            nsel = max(len(s) for s in sels.values())
            pad = max(1, eng.ecfg.sel_pad)
            self._round["layers"][li] = {
                "B": len(order), "nc": max(-(-int(L) // chunk)
                                           for L in lengths),
                "nsel": -(-nsel // pad) * pad, "live_rows": live,
                "rows": live + len(order)}
            return sels, stats

        def rec_admit(sid, tokens, **kw):
            t0 = time.perf_counter()
            out = admit(sid, tokens, **kw)
            self.admits.append({"t0": t0, "t1": time.perf_counter(),
                                "S": len(tokens), **eng.admit_profiles[-1]})
            return out

        st = eng.store
        fetch = st.fetch_chunks_pooled

        def rec_fetch(li, chunks_by_seq, **kw):
            out = fetch(li, chunks_by_seq, **kw)
            for sid, chunks in chunks_by_seq.items():
                held = {int(c): self.comp[(li, sid, int(c))] for c in chunks
                        if (li, sid, int(c)) in self.comp}
                if held:
                    L = self._round["lengths"][sid]
                    self.int4[self._cur[sid]].setdefault(L, {})[li] = held
            return out

        for li, pool in enumerate(st.pools):
            self._watch_pool(li, pool, eng.chunk)
        eng.decode_round = span("bench.round", rec_round)
        eng._select_chunks_batched = span("bench.evaluate", rec_select)
        eng._admit = rec_admit
        st.fetch_chunks_pooled = rec_fetch
        if spans:
            eng._admit = span("bench.admit", eng._admit)
            st.fetch_chunks_pooled = span("bench.fetch",
                                          st.fetch_chunks_pooled)
            st.append_tokens_batch = span("bench.append",
                                          st.append_tokens_batch)
            st.ingest = span("bench.ingest", st.ingest)
            batcher.step = span("bench.step", batcher.step)

    def _watch_pool(self, li: int, pool, chunk: int) -> None:
        alloc, scatter = pool.alloc, pool.scatter
        key_of: Dict[int, tuple] = {}     # slot -> the key it was given

        def rec_alloc(key, pinned):
            slot, evicted = alloc(key, pinned)
            key_of[slot] = key
            self.comp.pop((li, *key), None)
            return slot, evicted

        def rec_scatter(slots, kv_plain, packed=None, **kw):
            n_comp = len(slots) - (0 if kv_plain is None else len(kv_plain))
            for i, slot in enumerate(slots):
                key = key_of.get(slot)
                if key is None:
                    continue
                row, c = key
                if i < n_comp:
                    L = self._round["lengths"][row]
                    self.comp[(li, row, c)] = min(chunk, L - c * chunk)
                else:
                    self.comp.pop((li, row, c), None)
            return scatter(slots, kv_plain, packed, **kw)

        pool.alloc, pool.scatter = rec_alloc, rec_scatter


# ---------------------------------------------------------------------------
# Driving the traffic
# ---------------------------------------------------------------------------


class Stamps:
    """Each request's output tokens on the benchmark's clock: the first at
    the scheduler's collection of it (``Request.t_first``), every later
    one when the ``step()`` that produced it returns."""

    def __init__(self):
        self.reqs: Dict[int, Any] = {}
        self.due: Dict[int, float] = {}
        self.times: Dict[int, List[float]] = {}
        self.inflight: Dict[int, Any] = {}

    def add(self, req, due: float) -> None:
        self.reqs[req.rid] = req
        self.due[req.rid] = due
        self.times[req.rid] = []
        self.inflight[req.rid] = req

    def update(self, now: float) -> None:
        for rid, req in list(self.inflight.items()):
            ts = self.times[rid]
            n = len(req.out)
            if n > len(ts):
                if not ts and req.t_first is not None:
                    ts.append(req.t_first)
                ts.extend([now] * (n - len(ts)))
            if req.t_done is not None:
                del self.inflight[rid]


def _tokens_between(stamps: Stamps, t0: float, t1: float) -> int:
    return sum(1 for ts in stamps.times.values() for t in ts if t0 <= t < t1)


def drive_closed(batcher, stamps, plan, mix, seconds, on_open, on_step):
    from repro_torch.serving.scheduler import Request
    for i, p in enumerate(plan):
        req = Request(rid=i, prompt=p.prompt, max_new=p.max_new)
        batcher.submit(req)
        stamps.add(req, time.perf_counter())
    while len(batcher.active) < len(plan) and batcher.pending_work:
        batcher.step()
    for _ in range(int(mix.get("warm_rounds", 4))):
        batcher.step()
    stamps.update(time.perf_counter())
    t_open = on_open()
    t_end = t_open + seconds
    n0 = sum(len(ts) for ts in stamps.times.values())
    while time.perf_counter() < t_end and batcher.active:
        batcher.step()
        stamps.update(time.perf_counter())
        on_step()
    t_close = time.perf_counter()
    produced = sum(len(ts) for ts in stamps.times.values()) - n0
    return {"t_open": t_open, "t_close": t_close, "tokens": produced,
            "measured": sorted(stamps.reqs)}


def drive_open(batcher, stamps, plan, mix, seconds, on_open, on_step):
    from repro_torch.serving.scheduler import Request
    warm_s, drain_s = float(mix["warm_s"]), float(mix["drain_s"])
    t_start = time.perf_counter()
    t_open = t_start + warm_s
    t_close = t_open + seconds
    nxt = 0
    opened = False
    lateness: List[float] = []
    measured: List[int] = []

    def submit_due(now):
        nonlocal nxt
        while nxt < len(plan) and t_start + plan[nxt].due <= now:
            due = t_start + plan[nxt].due
            req = Request(rid=nxt, prompt=plan[nxt].prompt,
                          max_new=plan[nxt].max_new)
            batcher.submit(req)
            stamps.add(req, due)
            lateness.append(now - due)
            if t_open <= due < t_close:
                measured.append(nxt)
            nxt += 1

    while True:
        now = time.perf_counter()
        if not opened and now >= t_open:
            t_open_real = on_open()
            opened = True
        submit_due(now)
        if opened and now >= t_close and (
                now >= t_close + drain_s
                or all(stamps.reqs[r].t_done is not None for r in measured)):
            break
        if batcher.pending_work:
            batcher.step()
        elif nxt < len(plan):
            time.sleep(max(0.0, min(0.05, t_start + plan[nxt].due
                                    - time.perf_counter())))
        else:
            time.sleep(0.01)
        stamps.update(time.perf_counter())
        if opened:
            on_step()
    t_end = time.perf_counter()
    # stop offering load; let what was admitted run out
    batcher.queue.clear()
    while batcher.pending_work:
        batcher.step()
    stamps.update(time.perf_counter())
    return {"t_open": t_open_real, "t_close": t_close, "t_end": t_end,
            "tokens": _tokens_between(stamps, t_open_real, t_close),
            "measured": measured, "lateness_s": lateness}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def _flush(root: str) -> None:
    """Write the store's files through to the disk before the window
    opens, so that set-up's writes are not written back in the window
    (on an H100 host whose disk is a network file system, four runs
    spread 6 % with the flush against 21 % without)."""
    for f in Path(root).rglob("*"):
        if f.is_file():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def _write_bytes() -> Optional[int]:
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except OSError:
        return None
    return None


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", overrides: Optional[Dict] = None,
        t_process: Optional[float] = None, keep: bool = False,
        spec_file: Optional[Path] = None) -> Dict:
    """One run of ``workload`` (from ``spec_file``, by default
    ``BENCHMARK.json``).  Returns the result line's dict and, with
    ``keep``, what the control needs (the samples and the inputs).
    ``overrides`` (tests) updates the model, mix, engine and scheduler
    settings."""
    t_process = time.perf_counter() if t_process is None else t_process
    import torch
    from bench import costs, devtrace, generator as traffic, reference, weights
    from repro_torch.models import lm
    from repro_torch.serving.engine import BatchedLeoAMEngine, EngineCfg
    from repro_torch.serving.scheduler import ContinuousBatcher, SchedulerCfg

    ctx = load_cell(workload, spec_file)
    ov = overrides or {}
    model = {**ctx["model"], **ov.get("model", {})}
    model["port"] = {**ctx["model"]["port"], **ov.get("port", {})}
    mix = {**ctx["mix"], **ov.get("mix", {})}
    arch = build_arch(model)
    port = model["port"]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    w0 = _write_bytes()

    # -- inputs: weights and requests from the seed -------------------------
    params = weights.make(lm.param_defs(arch), seed,
                          getattr(torch, arch.dtype), dev)
    ecfg = EngineCfg(**{**port.get("engine", {}), **ov.get("engine", {})})
    scfg = SchedulerCfg(**{**port.get("scheduler", {}),
                           **mix.get("scheduler", {}),
                           **ov.get("scheduler", {})})
    if mix["kind"] == "closed":
        plan = traffic.closed_sessions(mix, seed, arch.vocab_size,
                                       ecfg.max_len)
    else:
        plan = traffic.open_arrivals(mix, seed, arch.vocab_size)
    ahead = scfg.prefill_ahead if (scfg.overlap_admission
                                   or scfg.chunked_admission) else 0
    store_dir = tempfile.mkdtemp(prefix="bench-store-")
    try:
        eng = BatchedLeoAMEngine(arch, params, ecfg,
                                 max_seqs=scfg.max_active + ahead,
                                 device=dev, store_root=store_dir)
        batcher = ContinuousBatcher(engine=eng, cfg=scfg)
        rec = Recorder(eng, batcher, spans=trace)
        stamps = Stamps()
        if mix["kind"] == "open":
            _warm_open(eng, batcher, plan, mix, arch)
        prof_box: Dict[str, Any] = {}
        trace_s = min(float(mix.get("trace_s", 6.0)), seconds)

        def on_open():
            _flush(store_dir)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            prof_box["setup_s"] = t - t_process
            prof_box["log0"] = dict(eng.store.log.bytes)
            prof_box["rounds0"] = len(rec.rounds)
            if trace and dev.type == "cuda":
                prof_box["prof"] = devtrace.start()
                prof_box["t_trace0"] = time.perf_counter()
            return t

        def on_step():
            p = prof_box.get("prof")
            if p is not None and time.perf_counter() - \
                    prof_box["t_trace0"] >= trace_s:
                prof_box["t_trace1"] = devtrace.stop(p)
                prof_box["done"] = prof_box.pop("prof")

        drive = drive_closed if mix["kind"] == "closed" else drive_open
        out = drive(batcher, stamps, plan, mix, seconds, on_open, on_step)
        if "prof" in prof_box:
            prof_box["t_trace1"] = devtrace.stop(prof_box["prof"])
            prof_box["done"] = prof_box.pop("prof")
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak = int(torch.cuda.max_memory_allocated(dev))
        else:
            peak = 0
        t_open, t_close = out["t_open"], out["t_close"]
        rounds = [r for r in rec.rounds[prof_box["rounds0"]:]
                  if r["t1"] <= t_close]
        profiles = eng.round_profiles[
            prof_box["rounds0"]:prof_box["rounds0"] + len(rounds)]
        # what the profiler slows is left out of the host-timed readings
        tr0 = prof_box.get("t_trace0", math.inf)
        tr1 = prof_box.get("t_trace1", math.inf)

        def untraced(a, b):
            return b <= tr0 or a >= tr1

        kept = [i for i, r in enumerate(rounds)
                if untraced(r["t0"], r["t1"])]
        log1 = dict(eng.store.log.bytes)
        h2d = sum(v - prof_box["log0"].get(k, 0.0) for k, v in log1.items()
                  if k[1] == "device")
        to_disk = sum(v for k, v in log1.items() if k[1] == "disk")
        record = {
            "model": model, "mix": mix, "window": out, "stamps": stamps,
            "setup_s": prof_box["setup_s"], "peak_bytes": peak,
            "rounds": rounds,
            "untraced_rounds": [rounds[i] for i in kept],
            "untraced_s": (t_close - t_open)
            - max(0.0, min(tr1, t_close) - max(tr0, t_open)),
            "round_profiles": [profiles[i] for i in kept],
            "admits": [a for a in rec.admits
                       if a["t1"] >= t_open and untraced(a["t0"], a["t1"])],
            "h2d_bytes": h2d, "costs": costs, "traced": (tr0, tr1)}
        if "done" in prof_box:
            t0, t1 = prof_box["t_trace0"], prof_box["t_trace1"]
            tr = devtrace.analyze(prof_box["done"], t1 - t0)
            tr["rounds"] = [r for r in rec.rounds
                            if r["t0"] >= t0 and r["t1"] <= t1]
            record["trace"] = tr
        # -- the program's state goes; the inputs stay ---------------------
        samples = _samples(ctx, mix, stamps, rec, out, seed, eng.chunk)
        rates = layer_rates(arch)
        rule_breaks = _selection_rule_breaks(rec, out["measured"], eng.chunk,
                                             arch.leoam, rates)
        failed = [r for r in out["measured"]
                  if stamps.reqs[r].error is not None
                  or not stamps.times[r]]
        eng.store.close()
        del eng, batcher, rec
        gc.collect()           # the recorder's wrappers hold the engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        layers = weights.layer_list(params, lm._layer_plan(arch))
        head = weights.head_of(params)
        ref_model = {**model, "head_dim": arch.hd}
        t_ref = time.perf_counter()
        evaluation = reference.Evaluation(rates)
        if samples:
            ref_rows = reference.logits(ref_model, layers, head, samples,
                                        evaluation=evaluation)
            served = [reference.served_tensor(s) for s in samples]
            numbers = {"widest_gap": reference.widest_gap(ref_rows, served),
                       "mean_gap": reference.mean_gap(ref_rows, served),
                       "selection_miss_share": evaluation.miss_share(),
                       "selection_rule_violations": rule_breaks}
        else:   # nothing finished to judge: no number can pass
            ref_rows = []
            numbers = {k: math.inf for k in ("widest_gap", "mean_gap",
                                             "selection_miss_share")}
            numbers["selection_rule_violations"] = rule_breaks
        ref_s = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

    metrics = {}
    specs = ctx["per_layer"] if trace else ctx["end_to_end"]
    for m in specs:
        v = load_metric(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks, correct = judge(ctx["checks"], numbers, len(failed))
    result = {
        "correct": bool(correct), "attempted": len(out["measured"]),
        "failed": len(failed), "metrics": metrics,
        "device": _device(dev, peak, record.get("trace"), ctx["chips"]),
    }
    if "trace" in record:
        result["breakdown"] = {
            "device_ops": record["trace"]["device_ops"],
            "idle_gaps": record["trace"]["idle_gaps"]}
    w1 = _write_bytes()
    result["write_bytes"] = None if w0 is None or w1 is None else w1 - w0
    result["store_disk_bytes"] = to_disk
    if mix["kind"] == "open":
        # each measured request: prompt length, queue wait, TTFT (s)
        result["requests"] = [
            [len(stamps.reqs[r].prompt),
             round(stamps.reqs[r].t_admit - stamps.due[r], 4)
             if stamps.reqs[r].t_admit is not None else None,
             round(stamps.times[r][0] - stamps.due[r], 4)
             if stamps.times[r] else None] for r in out["measured"]]
    result["reference_s"] = ref_s
    result["served_compared"] = sum(len(s.served) for s in samples)
    result["checks"] = checks
    if keep:
        return {"result": result, "numbers": numbers, "samples": samples,
                "layers": layers,
                "head": head, "ref_model": ref_model, "ref_rows": ref_rows,
                "params": params}
    return {"result": result}


def _device(dev, peak, tr, chips) -> Dict:
    import torch
    if dev.type == "cuda":
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
             "count": chips, "memory_peak_bytes": peak}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": chips,
             "memory_peak_bytes": peak}
    if tr is not None:
        d["busy_s"] = tr["busy_s"]
        d["window_s"] = tr["window_s"]
    return d


def _warm_open(eng, batcher, plan, mix, arch) -> None:
    """Set-up for an open loop: one request of each prefill bucket the mix
    can send runs through the batcher to its end (every prefill shape and
    the decode round at 1..max_active sequences), then the engine's
    window reads the engine's counters as deltas."""
    from repro_torch.serving.scheduler import Request
    buckets = {}
    for p in plan:
        buckets.setdefault(eng._bucket_len(len(p.prompt)), len(p.prompt))
    lens = sorted(buckets.values())
    n = max(len(lens), batcher.cfg.max_active)
    rng = np.random.default_rng(12345)
    for i in range(n):
        batcher.submit(Request(
            rid=-1 - i, prompt=rng.integers(0, arch.vocab_size,
                                            lens[i % len(lens)]),
            max_new=int(mix["max_new"])))
    while batcher.pending_work:
        batcher.step()


def _samples(ctx, mix, stamps, rec, out, seed, chunk):
    """The requests whose served tokens the reference judges: every
    session of a closed loop; of an open loop, the finished requests due
    in the window, up to ``sample`` of them drawn from the seed with the
    longest prompt always in."""
    from bench.reference import Sample
    done = [r for r in out["measured"]
            if stamps.reqs[r].error is None and stamps.reqs[r].out]
    if mix["kind"] == "open" and done:
        k = int(mix.get("sample", 16))
        longest = max(done, key=lambda r: len(stamps.reqs[r].prompt))
        rest = [r for r in done if r != longest]
        rng = np.random.default_rng(seed + 7)
        pick = list(rng.choice(rest, size=min(k - 1, len(rest)),
                               replace=False)) if rest else []
        done = [longest] + [int(r) for r in pick]
    samples = []
    for rid in done:
        req = stamps.reqs[rid]
        sels = {p: [by_layer[li] for li in sorted(by_layer)]
                for p, by_layer in rec.sels.get(rid, {}).items()}
        samples.append(Sample(req.prompt, req.out, sels, chunk,
                              rec.int4.get(rid, {})))
    return samples


def _selection_rule_breaks(rec, measured, chunk, leoam, rates) -> int:
    """The rules every selection keeps, checked by themselves (the
    reference attends over the program's choices; ``selection_miss_share``
    judges what it chose): each selection the measured requests attended
    holds the sink chunks and the most recent ones, only chunks that hold
    rows, and at least the configured rate's share of the rows.  Returns
    the number of selections that break a rule."""
    bad = 0
    for rid in measured:
        for L, by_layer in rec.sels.get(rid, {}).items():
            nv = -(-L // chunk)
            forced = set(range(min(nv, leoam.sink_chunks)))
            forced.update(range(max(0, nv - leoam.recent_chunks), nv))
            for li, sel in by_layer.items():
                budget = min(L, max(chunk, math.ceil(L * rates[li])))
                rows = sum(min(chunk, L - c * chunk) for c in set(sel)
                           if 0 <= c < nv)
                if not forced <= set(sel) or max(sel) >= nv or \
                        min(sel) < 0 or rows < budget:
                    bad += 1
    return bad


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------


def main(argv: List[str], t_process: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()
    import torch
    ctx = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < ctx["chips"]:
        print(f"error: the cell needs {ctx['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              t_process=t_process)
    res = out["result"]
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(res))
    return 0
