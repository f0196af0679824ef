"""The port's observability plane (``mx_rcnn_tpu_torch/obs``) against the JAX
package's, on the same inputs:

  * the same seeded sequence of counter, gauge and histogram operations
    renders the same Prometheus text, snapshot and percentiles in both
    registries, and ``percentile_from_counts`` agrees;
  * ``events.render`` gives the same level and line for every kind of the
    JAX table, the ``serve`` and ``ctrl`` kinds among them;
  * the flight ring is bounded as in JAX, and dumps nothing unconfigured;
  * the port's plane, unconfigured, puts events in its ring and counts
    them, records no span and writes no file.
All exact: the modules are host Python.
"""

from __future__ import annotations

import logging
import random

import pytest

from mx_rcnn_tpu.obs import events as JE
from mx_rcnn_tpu.obs.flight import FlightRecorder as JaxFlightRecorder
from mx_rcnn_tpu.obs import metrics as JM
from mx_rcnn_tpu_torch import obs
from mx_rcnn_tpu_torch.obs import events as TE
from mx_rcnn_tpu_torch.obs.flight import FlightRecorder
from mx_rcnn_tpu_torch.obs import metrics as TM


def _drive(registry, seed: int) -> None:
    rng = random.Random(seed)
    labels = [{}, {"level": "full"}, {"level": "small", "replica": "0"},
              {"tenant": "a", "replica": "-"}]
    for _ in range(400):
        kind = rng.choice(("counter", "gauge", "histogram"))
        name = f"{kind}_{rng.randrange(3)}"
        lab = rng.choice(labels)
        if kind == "counter":
            registry.counter(name, "help text").inc(rng.choice((1.0, 2.5, 0.125)), **lab)
        elif kind == "gauge":
            g = registry.gauge(name)
            if rng.random() < 0.5:
                g.set(rng.uniform(-5, 5), **lab)
            else:
                g.inc(rng.choice((1.0, -0.5)), **lab)
        else:
            buckets = (0.125, 0.5, 1.0) if name.endswith("0") else TM.DEFAULT_LATENCY_BUCKETS_S
            registry.histogram(name, "latency", buckets).observe(rng.expovariate(2.0), **lab)


@pytest.mark.parametrize("seed", range(3))
def test_registry_renders_as_jax(seed):
    ours, theirs = TM.Registry(), JM.Registry()
    _drive(ours, seed)
    _drive(theirs, seed)
    assert ours.render() == theirs.render()
    assert ours.snapshot() == theirs.snapshot()
    for name in ("histogram_0", "histogram_1", "histogram_2"):
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            for lab in ({}, {"level": "full"}):
                assert ours.histogram(name).percentile(q, **lab) == \
                    theirs.histogram(name).percentile(q, **lab)
    assert TM.DEFAULT_LATENCY_BUCKETS_S == JM.DEFAULT_LATENCY_BUCKETS_S


def test_registry_refuses_a_kind_change_as_jax():
    for mod in (TM, JM):
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered as Counter"):
            reg.gauge("x")
    assert TM.Histogram.__name__ == JM.Histogram.__name__


@pytest.mark.parametrize("counts", [[], [0, 0, 0], [1, 0, 3], [5, 2, 0, 1], [0, 0, 0, 7]])
def test_percentile_from_counts_equal(counts):
    le = (0.1, 0.5, 1.0, 2.0)[:len(counts)]
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert TM.percentile_from_counts(le, counts, q) == JM.percentile_from_counts(le, counts, q)


def test_snapshot_delta_and_window_equal():
    older, newer = TM.Registry(), TM.Registry()
    _drive(older, 7)
    _drive(newer, 8)
    older, newer = older.snapshot(), newer.snapshot()
    assert TM.snapshot_delta(older, newer) == JM.snapshot_delta(older, newer)
    wins = TM.SnapshotWindow(horizon_s=10.0), JM.SnapshotWindow(horizon_s=10.0)
    for w in wins:
        w.observe(0.0, older)
        w.observe(4.0, newer)
    assert wins[0].delta_over(3.0) == wins[1].delta_over(3.0)
    assert wins[0].rate("counter_0") == wins[1].rate("counter_0")


# A payload every formatter can read: any key a formatter asks for is there.
class _Anything(dict):
    def __missing__(self, key):
        return 3


@pytest.mark.parametrize("kind", sorted(JE.EVENTS))
def test_events_render_as_jax(kind):
    assert kind in TE.EVENTS
    for subsystem, payload in (("serve", _Anything(reason="r", level="full")),
                               ("ctrl", {}), ("serve", {"bad": object()})):
        try:
            want = JE.render(subsystem, kind, payload)
        except Exception as e:  # noqa: BLE001 - the port must raise alike
            with pytest.raises(type(e)):
                TE.render(subsystem, kind, payload)
        else:
            assert TE.render(subsystem, kind, payload) == want


def test_event_tables_and_open_vocabulary_equal():
    assert sorted(TE.EVENTS) == sorted(JE.EVENTS)
    assert {k: v[0] for k, v in TE.EVENTS.items()} == {k: v[0] for k, v in JE.EVENTS.items()}
    assert TE.render("serve", "no_such_kind", {"a": 1}) == JE.render("serve", "no_such_kind",
                                                                    {"a": 1})


def test_flight_ring_is_bounded_as_jax():
    ours, theirs = FlightRecorder(size=8), JaxFlightRecorder(size=8)
    for i in range(30):
        ours.record({"i": i})
        theirs.record({"i": i})
    assert ours.entries() == theirs.entries() == [{"i": i} for i in range(22, 30)]


def test_unconfigured_plane_rings_and_counts_events(tmp_path, caplog, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = obs.registry().counter("obs_events_total").value(subsystem="serve",
                                                              kind="engine_dead")
    with caplog.at_level(logging.ERROR):
        rec = obs.emit("serve", "engine_dead", {"reason": "hung", "queued": 2})
    assert rec["kind"] == "engine_dead" and obs.flight().entries()[-1] is rec
    assert obs.registry().counter("obs_events_total").value(
        subsystem="serve", kind="engine_dead") == before + 1
    assert JE.render("serve", "engine_dead", {"reason": "hung", "queued": 2})[1] in caplog.text
    obs.counter("port_test_total").inc(2, x="1")
    assert 'port_test_total{x="1"} 2' in obs.render_metrics()
    assert list(tmp_path.iterdir()) == []
