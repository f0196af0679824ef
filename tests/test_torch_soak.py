"""The port's soak rehearsal and deploy watcher (``mx_rcnn_tpu_torch/tools``)
on fake engines, on the CPU.

* ``tools/soak.py --fake-engines --deploy --duration 8``: the assertions of
  the JAX package's soak test (``tests/test_ctrl.py::TestSoakSmoke``: the
  verdict HELD, nothing failed, a replica killed and quarantined, both
  SLOs held, the resize timeline's decisions with their signals), plus a
  deploy story that ends ``promoted`` on the candidate the soak dropped
  (the served weights, saved under a fresh step by ``save_checkpoint``).
* ``tools/deploy_watch.py --fake-engines`` over a directory holding one
  port checkpoint: one JSON line whose decisions promote it, and a journal
  that replays through ``obs/report.py`` to the same deploy timeline.
* ``tools/loadgen.py``'s shared helpers (``make_profile``, the tenant
  spec, ``_percentile``) equal the JAX tool's.

Both tools run in-process through their ``main(argv)``, the function
``python -m`` calls (the module entry itself is checked with ``--help``).
Each stops every fleet, engine and loop it starts before it returns.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mx_rcnn_tpu_torch import obs as TO
from mx_rcnn_tpu_torch.obs.report import build_report
from mx_rcnn_tpu_torch.tools import deploy_watch, loadgen, soak
from mx_rcnn_tpu_torch.train import checkpoint as TCk

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_plane():
    TO.reset()
    yield
    TO.reset()


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_fake_engine_soak_with_deploy_holds_and_promotes(tmp_path, capsys):
    rc = soak.main(["--fake-engines", "--deploy", "--duration", "8", "--qps", "30",
                    "--service-time", "0.01", "--deadline", "20", "--ctrl-period", "0.25",
                    "--obs-dir", str(tmp_path / "obs"),
                    "--deploy-ckpt-dir", str(tmp_path / "ckpt")])
    out, err = capsys.readouterr()
    assert rc == 0, out + err
    assert "[soak] SLO VERDICT: HELD" in err, err
    rec = _last_json(out)
    assert rec["bench"] == "soak" and rec["pass"]
    assert rec["failed"] == 0 and rec["completed"] > 0
    assert rec["killed_rid"] is not None
    assert rec["quarantines"] >= 1
    verdicts = {v["slo"]: v for v in rec["slo"]["verdicts"]}
    assert set(verdicts) == {"availability", "latency"}
    assert all(v["held"] for v in verdicts.values())
    assert "full" in rec["latency_by_level"]
    for d in rec["resize_timeline"]:
        assert d["action"] in ("up", "down") and "signals" in d
    story = rec["deploy"]
    assert story["promoted"] and story["decided"] and not story["rejected"]
    assert not story["rolled_back"] and story["generation_final"] >= 1
    assert [e["kind"] for e in story["timeline"]] == [
        "deploy_candidate", "deploy_shadow_start", "deploy_shadow_verdict", "deploy_promote"]
    verdict = story["timeline"][2]
    assert verdict["verdict"] == "promote" and verdict["mismatched"] == 0
    assert verdict["mirrored"] >= 4
    assert "candidate promoted" in err
    assert TCk.verify_manifest(str(tmp_path / "ckpt"), 1) == (True, "ok")


def test_deploy_watch_promotes_a_landed_checkpoint(tmp_path, capsys):
    ckpt, obs_dir = str(tmp_path / "ckpt"), str(tmp_path / "obs")
    TCk.save_checkpoint(ckpt, TCk.weights_payload(3, {"w": np.zeros((4,), np.float32)}))
    rc = deploy_watch.main(["--ckpt-dir", ckpt, "--fake-engines", "--duration", "3",
                            "--mirror-rate", "1", "--min-mirrored", "3",
                            "--shadow-window", "2", "--watch-window", "1", "--poll", "0.2",
                            "--ctrl-period", "0.2", "--obs-dir", obs_dir])
    out, err = capsys.readouterr()
    assert rc == 0, out + err
    lines = [ln for ln in out.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["promotions"] == 1 and rec["rejections"] == 0 and rec["failed"] == 0
    assert rec["generation"] >= 1 and rec["completed"] > 0
    kinds = [d["kind"] for d in rec["decisions"]]
    assert kinds == ["deploy_candidate", "deploy_shadow_start", "deploy_shadow_verdict",
                     "deploy_promote"]
    assert all(d["step"] == 3 for d in rec["decisions"])
    report, _ = build_report(obs_dir)
    assert [e["kind"] for e in report["incident_timeline"]
            if e["kind"].startswith("deploy_")] == kinds


def test_soak_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "mx_rcnn_tpu_torch.tools.soak", "--help"],
                          capture_output=True, text=True, timeout=10, cwd=REPO_ROOT)
    assert proc.returncode == 0 and "--deploy" in proc.stdout and "--device" in proc.stdout


def _jax_loadgen():
    spec = importlib.util.spec_from_file_location(
        "loadgen_jax", os.path.join(REPO_ROOT, "tools", "loadgen.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_loadgen_helpers_match_jax():
    jl = _jax_loadgen()
    assert loadgen.PROFILES == jl.PROFILES
    ts = np.linspace(0, 30, 61)
    for name in loadgen.PROFILES:
        kw = dict(amplitude=0.7, period_s=7.0, spike_factor=3.0, duty=0.2)
        ours, theirs = loadgen.make_profile(name, 8.0, **kw), jl.make_profile(name, 8.0, **kw)
        assert [ours(t) for t in ts] == [theirs(t) for t in ts]
    spec = "victim:weight=4,qps=5;flood:rate=6,burst=4,qps=30,role=flooder;b:profile=spike"
    assert loadgen.parse_tenant_load_spec(spec) == jl.parse_tenant_load_spec(spec)
    parsed = loadgen.parse_tenant_load_spec(spec)
    assert loadgen.tenant_table_string(parsed) == jl.tenant_table_string(parsed)
    for bad in ("", ":qps=1", "a:qps", "a:nope=1", "a:qps=1;a:qps=2", "a:profile=x"):
        with pytest.raises(ValueError):
            loadgen.parse_tenant_load_spec(bad)
        with pytest.raises(ValueError):
            jl.parse_tenant_load_spec(bad)
    vals = sorted(np.random.default_rng(3).uniform(size=37).tolist())
    for q in (0.0, 0.5, 0.99, 1.0):
        assert loadgen._percentile(vals, q) == jl._percentile(vals, q)
    assert np.isnan(loadgen._percentile([], 0.5))


def test_occupancy_summary_matches_jax():
    """The same seeded fills on two replicas and two levels, observed into
    each package's ``serve_batch_occupancy`` as the engines do: the same
    summary (and the empty one before any call)."""
    from mx_rcnn_tpu import obs as JO

    jl = _jax_loadgen()
    JO.reset()
    try:
        assert loadgen._occupancy_summary() == jl._occupancy_summary() \
            == {"device_calls": 0, "mean": None, "p50": None}
        fills = np.random.default_rng(5).integers(1, 9, size=(4, 25)) / 8
        for plane in (TO, JO):
            h = plane.histogram("serve_batch_occupancy",
                                "request slots filled / slots total per device call",
                                buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
            for i, row in enumerate(fills):
                for f in row:
                    h.observe(float(f), level=("full", "reduced")[i % 2], replica=str(i // 2))
        ours = loadgen._occupancy_summary()
        assert ours == jl._occupancy_summary() and ours["device_calls"] == 100
    finally:
        JO.reset()
