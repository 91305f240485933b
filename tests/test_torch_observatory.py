"""The port's observatory against the JAX package's, on the CPU, with
``time.monotonic`` and ``time.time`` pinned to one clock.

- One seeded stream of four nodes' timeline batches (``step``,
  ``data_stall``, ``restart`` and ``fault_injected`` records), heartbeats
  and step reports goes into each package's ``HealthEngine``: node 2
  steps three times slower (a straggler) and node 3 falls silent while
  its agent keeps beating (a hang).  The snapshots are equal to 1e-9,
  the ``DiagnosisManager`` conclusions over them (with log and agent
  reports the error patterns match) are equal, and so are the
  ``MasterHealth`` verdicts over the same RPC observations.
- The same RPC observations into each package's ``MasterSelfTelemetry``
  give equal snapshots and byte-equal Prometheus text.
- The port's master serves ``/status`` equal to the ``JobStatusRequest``
  RPC's payload, and ``/metrics`` with the RPC latency histograms.
- Strategy measurements that the JAX service wrote into a Brain db read
  back in the port's service under the same ``workload_signature``.
- The agent's diagnosis collectors ship the same reports as the JAX
  ones from one growing, truncated training log and one card-stats
  file; the job stats collector dumps the same records.
"""

import json
import os
import time
import urllib.error
import urllib.request
from dataclasses import asdict

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from dlrover_tpu.accelerate import engine_service as jservice  # noqa: E402
from dlrover_tpu.agent import diagnosis_collector as jcol  # noqa: E402
from dlrover_tpu.master import datastore as jds  # noqa: E402
from dlrover_tpu.master import diagnosis as jdiag  # noqa: E402
from dlrover_tpu.master import job_manager as jjm  # noqa: E402
from dlrover_tpu.master import speed_monitor as jspeed  # noqa: E402
from dlrover_tpu.master import stats as jstats  # noqa: E402
from dlrover_tpu.observability import health as jhealth  # noqa: E402
from dlrover_tpu.observability import metrics as jmetrics  # noqa: E402
from dlrover_tpu.observability import self_telemetry as jtel  # noqa: E402
from dlrover_tpu_torch.accelerate import engine_service as tservice  # noqa: E402
from dlrover_tpu_torch.agent import diagnosis_collector as tcol  # noqa: E402
from dlrover_tpu_torch.common import messages as tmsg  # noqa: E402
from dlrover_tpu_torch.common.comm import MasterChannel  # noqa: E402
from dlrover_tpu_torch.common.env import get_free_port  # noqa: E402
from dlrover_tpu_torch.master import datastore as tds  # noqa: E402
from dlrover_tpu_torch.master import diagnosis as tdiag  # noqa: E402
from dlrover_tpu_torch.master import job_manager as tjm  # noqa: E402
from dlrover_tpu_torch.master import speed_monitor as tspeed  # noqa: E402
from dlrover_tpu_torch.master import stats as tstats  # noqa: E402
from dlrover_tpu_torch.observability import health as thealth  # noqa: E402
from dlrover_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from dlrover_tpu_torch.observability import self_telemetry as ttel  # noqa: E402

SEED = 20261018
T0_WALL = 1_790_000_000.0
T0_MONO = 5_000.0


class Clock:
    """``time.time`` and ``time.monotonic`` moved by hand."""

    def __init__(self):
        self.elapsed = 0.0

    def wall(self):
        return T0_WALL + self.elapsed

    def mono(self):
        return T0_MONO + self.elapsed


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(time, "time", c.wall)
    monkeypatch.setattr(time, "monotonic", c.mono)
    return c


def approx_equal(a, b, tol=1e-9):
    """Equal structure, and numbers equal to ``tol`` (relative)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            approx_equal(a[k], b[k], tol) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            approx_equal(x, y, tol) for x, y in zip(a, b))
    if (isinstance(a, float) or isinstance(b, float)) and not (
            isinstance(a, bool) or isinstance(b, bool)):
        return abs(a - b) <= tol * max(1.0, abs(a), abs(b))
    return a == b


# --------------------------------------------- the health engine stream


def _stream():
    """Per tick: ``(seconds to advance, [(node, events)], heartbeats,
    step reports)``.  Nodes 0 and 1 step every tick, node 2 every third
    (the straggler), node 3 stops after tick 12 but keeps beating."""
    rng = np.random.default_rng(SEED)
    ticks, steps, pid = [], {n: 0 for n in range(4)}, 100
    for tick in range(60):
        dt = 0.5 if tick < 40 else 3.5
        batches = []
        for node in range(4):
            if node == 3 and tick > 12:
                continue
            if node == 2 and tick % 3:
                continue
            steps[node] += 1
            dur = (1.5 if node == 2 else 0.5) * (
                1.0 + 0.05 * float(rng.standard_normal()))
            inc = 1 if node == 0 and tick >= 6 else 0
            evs = [{"name": "step", "ph": "X", "dur": dur,
                    "wall_back": dur, "node": node, "rank": node,
                    "inc": inc, "pid": pid + node,
                    "labels": {"step": steps[node]}}]
            if node == 1 and tick % 4 == 0:
                evs.append({"name": "data_stall", "ph": "X",
                            "dur": float(rng.uniform(0.05, 0.4)),
                            "wall_back": 0.5, "node": 1, "rank": 1,
                            "inc": 0, "pid": pid + 1,
                            "labels": {"stage": rng.choice(
                                ["host_fetch", "h2d"]).item()}})
            if node == 0 and tick == 5:
                evs.append({"name": "restart", "ph": "B", "node": 0,
                            "rank": 0, "inc": 0, "pid": 7,
                            "wall_back": 0.1, "labels": {}})
            if node == 0 and tick == 6:
                evs.append({"name": "restart", "ph": "E", "node": 0,
                            "rank": 0, "inc": 1, "pid": 7,
                            "wall_back": 0.0, "labels": {}})
            if node == 1 and tick == 7:
                evs.append({"name": "fault_injected", "ph": "i",
                            "node": 1, "rank": 1, "inc": 0, "pid": 9,
                            "wall_back": 0.0,
                            "labels": {"kind": "kill", "target": "agent"}})
            batches.append((node, evs))
        ticks.append((dt, batches, list(range(4)),
                      [(n, steps[n]) for n, _ in batches]))
    return ticks


def _drive(engine, clock, ticks):
    for dt, batches, beats, reports in ticks:
        clock.elapsed += dt
        for node, evs in batches:
            engine.observe_events(node, [
                {k: v for k, v in dict(
                    e, wall=time.time() - e["wall_back"]).items()
                 if k != "wall_back"} for e in evs])
        for node in beats:
            engine.observe_heartbeat(node, time.time())
        for node, step in reports:
            engine.observe_step(node, step, time.time())
        engine.observe_resource(1, 37.5, 2048.0)


def _telemetry_calls(tel, clock):
    """The same RPC observations: fast kinds with a slow tail past
    ``MasterHealth``'s 0.5 s p99, parked waits and rejected ones."""
    rng = np.random.default_rng(SEED + 1)
    kinds = ["HeartBeat", "KeyValuePair", "JoinRendezvousRequest",
             "KVWaitRequest", "TimelineEventsReport"]
    for i in range(80):
        clock.elapsed += 0.25
        kind = kinds[i % len(kinds)]
        tel.rpc_begin()
        lat = float(rng.exponential(0.004))
        if i % 9 == 0:
            lat = 0.6 + float(rng.random())
        tel.rpc_end(kind, lat, int(rng.integers(40, 9000)),
                    None if i % 11 == 0 else int(rng.integers(8, 500)))
    for _ in range(4):
        tel.rpc_begin()
        tel.wait_parked()
    for _ in range(2):
        tel.wait_rejected()


def _run_observatory(pkg, clock, registry):
    health, diag, tel = pkg
    engine = health.HealthEngine(job="j", registry=registry)
    telemetry = tel.MasterSelfTelemetry(registry=registry, pool_size=4,
                                        window_s=60.0)
    master_health = health.MasterHealth(telemetry, sustain=2)
    manager = diag.DiagnosisManager(health_engine=engine, job="j",
                                    master_health=master_health)
    _drive(engine, clock, _stream())
    for node, line, kind in (
            (1, "RESOURCE_EXHAUSTED: out of memory allocating 2.0G",
             diag.DiagnosisDataType.TRAINING_LOG),
            (2, "host maintenance event scheduled",
             diag.DiagnosisDataType.AGENT_REPORT)):
        manager.collect_data(diag.DiagnosisData(
            data_type=kind, content=line, node_rank=node))
    _telemetry_calls(telemetry, clock)
    first = manager.diagnose()
    clock.elapsed += 1.0
    second = manager.diagnose()
    engine.refresh_gauges()
    return {
        "snapshot": engine.snapshot(),
        "stragglers": engine.stragglers(),
        "hangs": engine.hang_suspects(),
        "stalls": engine.stall_shares(),
        "conclusions": [[asdict(c) for c in first],
                        [asdict(c) for c in second]],
        "recent": manager.recent_conclusions(),
        "master_health": master_health.status(),
        "telemetry": telemetry.snapshot(),
        "text": registry.render_text(),
    }


def test_health_diagnosis_and_master_health_equal_jax(clock, tmp_path):
    out = {}
    for name, pkg, reg in (
            ("jax", (jhealth, jdiag, jtel), jmetrics.MetricsRegistry(
                path=str(tmp_path / "jax.prom"))),
            ("torch", (thealth, tdiag, ttel), tmetrics.MetricsRegistry())):
        clock.elapsed = 0.0
        out[name] = _run_observatory(pkg, clock, reg)
    want, got = out["jax"], out["torch"]
    for key in want:
        assert approx_equal(got[key], want[key]), key
    # the stream holds what it says: one straggler, one hang, a stall,
    # a restart and a fault, and the conclusions name them
    snap = got["snapshot"]
    assert snap["stragglers"] == [2] and snap["hangs"] == [3]
    nodes = {n["node"]: n for n in snap["nodes"]}
    assert nodes[0]["restarts"] == 1 and nodes[0]["inc"] == 1
    assert nodes[1]["faults"] == 1 and nodes[1]["stall_share"]
    problems = {(c["problem"], c["node_rank"])
                for c in got["conclusions"][0]}
    assert {("straggler", 2), ("hang", 3), ("oom", 1),
            ("preemption", 2)} <= problems
    verdicts = got["master_health"]["last_verdicts"]
    assert {v["reason"] for v in verdicts} == {"rpc_p99",
                                               "pool_saturated"}


def test_self_telemetry_snapshot_and_prometheus_text_equal_jax(
        clock, tmp_path):
    out = {}
    for name, tel, reg in (
            ("jax", jtel, jmetrics.MetricsRegistry(
                path=str(tmp_path / "jax.prom"))),
            ("torch", ttel, tmetrics.MetricsRegistry())):
        clock.elapsed = 0.0
        telemetry = tel.MasterSelfTelemetry(registry=reg, pool_size=8,
                                            window_s=30.0)
        _telemetry_calls(telemetry, clock)
        telemetry.refresh_gauges()
        out[name] = (telemetry.snapshot(), telemetry.window_p99(),
                     telemetry.occupancy(), reg.render_text())
    assert out["torch"][:3] == out["jax"][:3]
    text = out["torch"][3]
    assert text == out["jax"][3]
    assert 'dlrover_tpu_master_rpc_latency_seconds_bucket{kind="HeartBeat"' \
        in text and "dlrover_tpu_master_rpc_response_bytes_sum" in text


def test_histograms_render_as_the_jax_registry_does(tmp_path):
    regs = (jmetrics.MetricsRegistry(path=str(tmp_path / "j.prom"),
                                     rank=3),
            tmetrics.MetricsRegistry(rank=3))
    rng = np.random.default_rng(SEED)
    values = rng.lognormal(-4, 2.5, 200)
    for reg in regs:
        for i, v in enumerate(values):
            reg.observe_histogram("lat", float(v),
                                  labels={"kind": f'k"{i % 3}'})
            reg.observe_histogram("size", float(v) * 1e6,
                                  bounds=tmetrics.SIZE_BOUNDS)
        reg.set_gauge("g", 1.5, labels={"a": "x\ny"})
        reg.inc_counter("c", 2.0)
    assert tmetrics.LATENCY_BOUNDS == jmetrics.LATENCY_BOUNDS
    assert tmetrics.SIZE_BOUNDS == jmetrics.SIZE_BOUNDS
    assert regs[1].render_text() == regs[0].render_text()
    for q in (0.5, 0.9, 0.99):
        assert (regs[1].histogram("size", {}).quantile(q)
                == regs[0].histogram("size", {}).quantile(q))


# --------------------------------------------- the master's HTTP surface


def test_the_masters_status_equals_the_job_status_rpc(monkeypatch):
    from dlrover_tpu_torch.master.master import LocalJobMaster

    monkeypatch.setenv("DLROVER_TPU_STATUS_PORT", "0")
    monkeypatch.delenv("DLROVER_TPU_BRAIN_DB", raising=False)
    m = LocalJobMaster(get_free_port(), node_num=2)
    m.prepare()
    chan = MasterChannel(m.addr, node_id=0)
    try:
        now = time.time()
        chan.report(tmsg.TimelineEventsReport(events=[
            {"name": "step", "ph": "X", "wall": now - 1.0 + 0.2 * i,
             "mono": 0.2 * i, "dur": 0.2, "node": 0, "rank": 0,
             "inc": 0, "pid": 1, "labels": {"step": i + 1}}
            for i in range(5)]))
        chan.report(tmsg.HeartBeat(timestamp=now))
        # an agent's diagnosis report reaches the chain through the
        # servicer, and its conclusion the status
        chan.report(tmsg.DiagnosisReportData(
            data_cls=tdiag.DiagnosisDataType.TRAINING_LOG,
            data_content="RESOURCE_EXHAUSTED: out of memory", node_rank=0))
        assert [(c.problem, c.node_rank)
                for c in m.diagnosis_manager.diagnose()] == [("oom", 0)]
        base = f"http://127.0.0.1:{m.status_server.port}"
        # both reads at one instant of the clock
        monkeypatch.setattr(time, "time", lambda: now)
        frozen = time.monotonic()
        monkeypatch.setattr(time, "monotonic", lambda: frozen)
        rpc = chan.get(tmsg.JobStatusRequest())
        http = json.loads(urllib.request.urlopen(
            base + "/status", timeout=10).read().decode())
        monkeypatch.undo()
        assert rpc.available
        want = json.loads(json.dumps(rpc.status, default=str))
        # the RPC itself is one more JobStatusRequest in the master's
        # own telemetry by the time /status reads it
        kinds_http = http.pop("master")["rpc"]
        kinds_rpc = want.pop("master")["rpc"]
        assert http == want
        assert (kinds_http["JobStatusRequest"]["count"]
                == kinds_rpc.get("JobStatusRequest", {"count": 0})["count"]
                + 1)
        assert [n["node"] for n in http["health"]["nodes"]] == [0]
        assert http["health"]["nodes"][0]["steps_seen"] == 5
        assert http["epoch"] == {"job_epoch": 0, "incarnation": 0}
        assert [(c["problem"], c["node_rank"])
                for c in http["conclusions"]] == [("oom", 0)]
        text = urllib.request.urlopen(
            base + "/metrics", timeout=10).read().decode()
        assert ('dlrover_tpu_master_rpc_latency_seconds_bucket'
                '{kind="TimelineEventsReport",le="0.0001"}') in text
        assert "dlrover_tpu_node_health" in text
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        chan.close()
        m.stop()


# ------------------------------------- the strategy service's history


def test_jax_service_history_reads_back_in_the_ports(tmp_path):
    db = str(tmp_path / "brain.db")
    req = dict(num_params=7_000_000_000, param_bytes=28_000_000_000,
               optimizer_bytes=56_000_000_000, num_layers=32,
               n_devices=16,
               activation_bytes_per_sample=32 * 7 * 2048 * 4096 * 2)
    meas = {k: v for k, v in req.items() if k != "n_devices"}
    jstore = jds.BrainDatastore(db)
    try:
        jsvc = jservice.StrategyService(datastore=jstore, job="jax-job")
        first = jsvc.generate(jservice.StrategyRequest(**req)).candidates
        for i, kw in enumerate(first[:4]):
            jsvc.record(jservice.StrategyMeasurement(
                strategy=kw, step_time_s=9.0 - 2 * i, **meas))
        want = jsvc.generate(jservice.StrategyRequest(**req))
    finally:
        jstore.close()
    tkey = tservice._workload_key(tservice.StrategyRequest(**req))
    jkey = jservice._workload_key(jservice.StrategyRequest(**req))
    assert tds.workload_signature(tkey) == jds.workload_signature(jkey)
    tstore = tds.BrainDatastore(db)
    try:
        rows = tstore.load_measurements(tds.workload_signature(tkey))
        assert [t for _, t in rows] == [9.0, 7.0, 5.0, 3.0]
        tsvc = tservice.StrategyService(datastore=tstore, job="port-job")
        got = tsvc.generate(tservice.StrategyRequest(**req))
    finally:
        tstore.close()
    assert got.calibrated and want.calibrated
    assert got.candidates == want.candidates


# ------------------------------------------- the agent's collectors


class _Reports:
    def __init__(self):
        self.reports = []

    def report_diagnosis_data(self, data_cls, data_content, node_rank=-1):
        self.reports.append((data_cls, data_content, node_rank))
        return True


def _collect(col_mod, tmp_path):
    """The reports of one package's collectors over one log that grows,
    is truncated, and one card-stats file read twice."""
    log = tmp_path / "train.log"
    log.write_text("step 1 loss 2.3\nRESOURCE_EXHAUSTED: Out of memory "
                   "allocating 12345 bytes\nstep 2 loss 2.2\n")
    logs = _Reports()
    col = col_mod.TrainingLogCollector(str(log), client=logs, node_rank=3)
    col._tick()
    col._tick()
    with open(log, "a") as f:
        f.write("Traceback (most recent call last):\nloss is nan\n")
    col._tick()
    log.write_text("short OOM line\n")
    col._tick()
    stats = tmp_path / "chip.json"
    stats.write_text(json.dumps([{"mem_used": 1 << 30, "util": 0.92}]))
    chips = _Reports()
    chip_col = col_mod.ChipMetricsCollector(str(stats), client=chips,
                                            node_rank=1)
    chip_col._tick()
    chip_col._tick()
    col_mod.TrainingLogCollector(str(tmp_path / "nope.log"),
                                 client=logs)._tick()
    return logs.reports, chips.reports


def test_the_collectors_ship_what_the_jax_ones_do(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _collect(jcol, tmp_path / "jax")
    got = _collect(tcol, tmp_path / "torch")
    assert got == want
    logs, chips = got
    assert [r[0] for r in logs] == [tdiag.DiagnosisDataType.TRAINING_LOG] * 3
    assert "RESOURCE_EXHAUSTED" in logs[0][1] and "loss 2.3" not in logs[0][1]
    assert "Traceback" in logs[1][1] and "OOM" in logs[2][1]
    assert [(c, r) for c, _, r in chips] == [
        (tdiag.DiagnosisDataType.CHIP_METRICS, 1)]


def _job_stats(stats, speed_mod, jm_mod, clock, path):
    """One package's ``JobMetricCollector`` over a speed monitor and a
    node table, ticked by hand, dumping to ``path``."""
    speed = speed_mod.SpeedMonitor()
    speed.set_target_worker_num(2)
    jm = jm_mod.LocalJobManager(2)
    jm.start()
    reporter = stats.LocalStatsReporter(
        stats.JobMeta(job_name="j", uuid="u"), dump_path=str(path))
    collector = stats.JobMetricCollector(reporter, speed_monitor=speed,
                                         job_manager=jm)
    collector.collect_model_info(7_000_000, flops_per_step=3.5e12,
                                 num_layers=2, seq_len=16, other=1)
    for step in range(1, 6):
        clock.elapsed += 1.5
        speed.collect_global_step(step * 10, time.time())
        jm.collect_node_heartbeat("worker", step % 2, time.time())
        jm.update_node_resource_usage("worker", step % 2, 0.5 * step,
                                      1024 * step)
        collector._tick()
    reporter.report_job_exit(True, "Succeeded")
    return path.read_text().splitlines(), len(reporter.runtime)


def test_job_stats_dump_what_the_jax_collector_dumps(clock, tmp_path):
    want = _job_stats(jstats, jspeed, jjm, clock, tmp_path / "jax.jsonl")
    clock.elapsed = 0.0
    got = _job_stats(tstats, tspeed, tjm, clock, tmp_path / "torch.jsonl")
    assert got == want
    lines, runtime = got
    assert runtime == 5 and len(lines) == 7
    last = json.loads(lines[-2])
    assert last["global_step"] == 50 and last["running_nodes"] == 2
