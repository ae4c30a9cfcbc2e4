"""The port's copies of ``obs``, ``faults`` and ``segments`` against the
JAX package's: the same calls through either package give the same span
trees and attributes, the same counter/gauge/histogram exports, the same
fault-plan matches and hit sequence under one seed, and a segmented log
appended by one package replays in the other with the same records."""

import numpy as np
import pytest

import repro.faults as ref_faults
import repro.obs as ref_obs
import repro.segments as ref_segments
import repro_torch.faults as my_faults
import repro_torch.obs as my_obs
import repro_torch.segments as my_segments

from _torch_threads import bounded_torch_threads  # noqa: F401

OBS = {"repro": ref_obs, "repro_torch": my_obs}
FAULTS = {"repro": ref_faults, "repro_torch": my_faults}
SEGMENTS = {"repro": ref_segments, "repro_torch": my_segments}


def _tree(records):
    """Span records with ids and clocks replaced by their structure:
    (name, attrs, parent's name, shares the first span's trace)."""
    by_id = {r["span"]: r for r in records}
    trace0 = records[0]["trace"] if records else None
    out = []
    for r in records:
        parent = by_id.get(r["parent"])
        out.append((r["name"], r.get("attrs", {}),
                    parent["name"] if parent else None,
                    r["trace"] == trace0))
    return out


def _spans_nested(obs):
    with obs.context(campaign="c7", stage="explore"):
        with obs.span("campaign.round", n=3) as sp:
            with obs.span("synth.batch", n=3, unique=2):
                with obs.span("synth.compile", kind="fresh"):
                    pass
            sp.set(extra=True)
        started = obs.start_span("synth.batch", n=1)
        started.end(waves=1, compiled=0)


def _spans_wire(obs):
    with obs.context(campaign="c9", trace_id="t-fixed"):
        wire = obs.wire_context()
    with obs.attach(wire, worker="w1"):
        with obs.span("sim.fused", g=4, sse=True):
            pass
    with obs.span("campaign.deliver", stage="final", n=2):
        pass


@pytest.mark.parametrize("scenario", [_spans_nested, _spans_wire],
                         ids=["nested", "wire"])
def test_span_trees_match(scenario):
    trees = {}
    for name, obs in OBS.items():
        rec = obs.recorder()
        rec.clear()
        scenario(obs)
        trees[name] = _tree(rec.snapshot())
        rec.clear()
    assert trees["repro"] == trees["repro_torch"]
    assert len(trees["repro"]) >= 2


def _exports(obs):
    reg = obs.Registry()
    c = reg.counter("repro_synth_compiles_total", "deployment runs paid")
    c.inc()
    c.inc(4)
    reg.gauge("repro_faults_active", "armed").set(1.0)
    h = reg.histogram("repro_synth_compile_seconds", "wall seconds")
    for v in (0.0004, 0.003, 0.3, 7.0, 1e4):
        h.observe(v)
    return (reg.render(), reg.snapshot(),
            reg.collect("repro_synth_"), h.samples(), h.count, h.sum)


def _timeline(obs):
    tl = obs.Timeline(maxlen=4)
    rng = np.random.default_rng(3)
    out = []
    for i in range(6):
        rec = tl.sample("c1", objectives=rng.random((12, 2)), labels=i * 10,
                        stage="explore")
        out.append({k: v for k, v in rec.items() if k not in ("t", "rel_s")})
    series = [{k: v for k, v in r.items() if k not in ("t", "rel_s")}
              for r in tl.series("c1")]
    return out, series, tl.reference("c1"), tl.campaigns()


def _chrome(obs):
    spans = [{"name": "synth.compile", "trace": "t1", "span": "s1",
              "parent": None, "t0": 10.0, "dur_s": 0.25,
              "attrs": {"kind": "fresh", "campaign": "c1"}},
             {"name": "sim.fused", "trace": "t1", "span": "s2",
              "parent": "s1", "t0": 10.1, "dur_s": 0.05,
              "attrs": {"g": 4}}]
    from importlib import import_module

    export = import_module(obs.__name__ + ".export")
    return export.to_chrome_trace(spans)


@pytest.mark.parametrize("call", [_exports, _timeline, _chrome],
                         ids=["metrics", "timeline", "chrome_trace"])
def test_same_calls_same_results(call):
    assert call(ref_obs) == call(my_obs)


def _fault_run(faults):
    plan = faults.FaultPlan(seed=11, name="drill")
    plan.add("synth.compile", kind="latency", p=0.5, delay_s=0.0)
    plan.add("store.*", kind="torn_write", p=0.3, after=2, times=4,
             fraction=0.5)
    plan.add("sched.dispatch", kind="drop", p=1.0, times=2)
    text = plan.to_json()
    faults.reset()
    faults.install(faults.FaultPlan.from_json(text))
    try:
        seq = []
        for i in range(40):
            for point in ("synth.compile", "store.append", "store.seal",
                          "sched.dispatch", "http.request"):
                f = faults.check(point, i=i)
                seq.append(None if f is None else (f.kind, f.rule.point))
        return text, seq, faults.stats(), faults.KINDS, faults.POINTS
    finally:
        faults.reset()


def test_fault_plan_matches_and_hit_sequence_under_one_seed():
    want = _fault_run(ref_faults)
    got = _fault_run(my_faults)
    assert got == want
    assert sum(s is not None for s in got[1]) > 10


def test_fault_error_rule_raises_through_hit():
    for faults in FAULTS.values():
        faults.reset()
        faults.install(faults.FaultPlan(seed=0).add(
            "synth.compile", kind="error", times=1))
        try:
            with pytest.raises(faults.FaultInjected, match="synth.compile"):
                faults.hit("synth.compile", kind="fresh")
            assert faults.hit("synth.compile", kind="fresh") is None
        finally:
            faults.reset()


def _append_all(seg, root, records):
    log = seg.SegmentedLog(root, segment_records=5, index_field="k",
                           name="synth")
    for i in range(0, len(records), 3):
        with log.lock():
            log.sync_locked()
            log.append_locked(records[i:i + 3])
    log.close()


def _replay(seg, root):
    log = seg.SegmentedLog(root, segment_records=5, index_field="k",
                           name="synth")
    with log.lock():
        m, tail = log.sync_locked()
        recs = []
        for e in m["sealed"]:
            got, bad = log.read_segment(e["name"])
            assert bad == 0
            recs += got
        recs += tail
        index = [log.read_index(e["name"]) for e in m["sealed"]]
    stats = log.stats()
    log.close()
    return recs, index, stats


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_segmented_log_replays_across_packages(tmp_path, writer, reader):
    records = [{"k": f"id{i:03d}", "s": f"st{i % 4}", "fam": "f",
                "c": {"flops": float(i * 1000), "hbm_bytes": i + 0.5}}
               for i in range(17)] + [{"fam": "f", "v": 0}]
    root = str(tmp_path / "synth.segd")
    _append_all(SEGMENTS[writer], root, records)
    got, index, stats = _replay(SEGMENTS[reader], root)
    want, want_index, want_stats = _replay(SEGMENTS[writer], root)
    assert got == records == want
    assert index == want_index and len(index) == 3
    assert stats == want_stats
    line = SEGMENTS[writer].frame_record(records[0])
    assert SEGMENTS[reader].parse_line(line[:-1]) == records[0]
    assert SEGMENTS[reader].parse_line("0" + line[1:-1]) is None


def test_port_restores_the_reference_spans_and_counters():
    """A small ``run_dse`` on the CPU records the spans the JAX package
    records on the same path (``campaign.round``, ``campaign.deliver``,
    ``synth.batch``, ``synth.compile``, ``sim.fused``), and the fused
    engine's calls count in ``fused.stats()`` and add up in the
    ``repro_sim_fused_*_total`` counters (the JAX package's re-register
    the counter on every call, so its total reads the last call's)."""
    from repro_torch.accel import GaussianFilter, fused
    from repro_torch.core import dse
    from repro_torch.core.acl.library import default_library
    from repro_torch.core.features import synth
    from repro_torch.core.nsga2 import NSGA2Config

    before = fused.stats()
    name = "repro_sim_fused_fused_qor_calls_total"
    counter = my_obs.REGISTRY.get(name)
    before_counted = counter.value if counter is not None else 0.0
    rec = my_obs.recorder()
    rec.clear()
    dse.run_dse(GaussianFilter(), default_library(), dse.DSEConfig(
        n_train=12, n_qor_samples=1, nsga=NSGA2Config(
            pop_size=8, n_parents=4, n_generations=1)), device="cpu")
    names = {r["name"] for r in rec.snapshot()}
    rec.clear()
    assert {"campaign.round", "campaign.deliver", "synth.batch",
            "synth.compile", "sim.fused"} <= names
    calls = fused.stats()["fused_qor_calls"] - before["fused_qor_calls"]
    assert calls >= 2
    assert my_obs.REGISTRY.get(name).value - before_counted == calls
    assert synth.synth_stats()["cache"]["compiles"] > 0
