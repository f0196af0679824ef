"""Traffic shapes and summaries shared by the soak and the deploy watcher
(the part of ``tools/loadgen.py`` of the JAX package that they import).

* :func:`make_profile` — an arrival-rate schedule ``rate(t) -> req/s``:
  ``constant``; ``sine``, a compressed diurnal curve ``qps * (1 +
  amplitude * sin(2*pi*t/period))``; ``spike``, a ``qps`` baseline with a
  burst of ``qps * spike_factor`` for the first ``duty`` of every period.
* :func:`parse_tenant_load_spec` / :func:`tenant_table_string` — the
  ``--tenants`` spec (``name:k=v,...;name2:...``): per-tenant offered
  load (``qps``, ``profile``, ``role``) and the ``serve.tenancy`` policy
  knobs, and the policy table rebuilt from it.
* :func:`_percentile` and :func:`_occupancy_summary` — the nearest-rank
  percentile and the batch-occupancy summary of a run's records.

The open-loop load generator itself (over a local fleet or a remote
gateway) is not here: it comes with the port's serving bench.
"""

from __future__ import annotations

import math
from typing import Callable

PROFILES = ("constant", "sine", "spike")


def make_profile(
    name: str,
    qps: float,
    *,
    amplitude: float = 0.5,
    period_s: float = 60.0,
    spike_factor: float = 4.0,
    duty: float = 0.15,
) -> Callable[[float], float]:
    """Arrival-rate schedule ``rate(t_elapsed) -> req/s``.

    Rates are floored at a small positive value — an open loop with rate
    exactly 0 would never schedule the next arrival and the clock math of
    its callers divides by it.
    """
    if qps <= 0:
        raise ValueError("qps must be > 0")
    if name == "constant":
        return lambda t: qps
    if name == "sine":
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError("amplitude must be in [0, 1]")
        return lambda t: max(
            0.05, qps * (1.0 + amplitude * math.sin(2 * math.pi * t / period_s))
        )
    if name == "spike":
        if not 0.0 < duty < 1.0:
            raise ValueError("duty must be in (0, 1)")
        return lambda t: (
            qps * spike_factor if (t % period_s) < duty * period_s else qps
        )
    raise ValueError(f"unknown profile {name!r} (want one of {PROFILES})")


_TENANT_POLICY_KEYS = ("weight", "rate", "burst", "priority")


def parse_tenant_load_spec(spec: str) -> list[dict]:
    """``--tenants`` entries: ``name:k=v,...;name2:...`` where the keys
    are the ``serve.tenancy`` policy knobs plus the load-side ``qps``,
    ``profile`` and ``role`` (``role=flooder`` marks the adversary the
    isolation verdict judges by its quota cap)."""
    out: list[dict] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, kvs = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant entry missing a name: {part!r}")
        ent = {"name": name, "qps": None, "profile": "constant",
               "role": "normal", "policy": {}}
        for kv in kvs.split(","):
            kv = kv.strip()
            if not kv:
                continue
            key, sep, val = kv.partition("=")
            key, val = key.strip(), val.strip()
            if not sep:
                raise ValueError(f"tenant {name!r}: malformed knob {kv!r}")
            if key == "qps":
                ent["qps"] = float(val)
            elif key == "profile":
                if val not in PROFILES:
                    raise ValueError(
                        f"tenant {name!r}: unknown profile {val!r}"
                    )
                ent["profile"] = val
            elif key == "role":
                ent["role"] = val
            elif key in _TENANT_POLICY_KEYS:
                ent["policy"][key] = val
            else:
                raise ValueError(
                    f"tenant {name!r}: unknown knob {key!r} (expected "
                    f"qps/profile/role or one of {_TENANT_POLICY_KEYS})"
                )
        out.append(ent)
    if not out:
        raise ValueError("empty --tenants spec")
    if len({e["name"] for e in out}) != len(out):
        raise ValueError("duplicate tenant name in --tenants spec")
    return out


def tenant_table_string(specs: list[dict]) -> str:
    """Rebuild the ``serve.tenancy.table`` string from parsed entries
    (policy knobs only — qps/profile/role are load-side)."""
    return ";".join(
        e["name"] + ":" + ",".join(
            f"{k}={v}" for k, v in e["policy"].items()
        )
        for e in specs
    )


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _occupancy_summary() -> dict:
    """Aggregate the ``serve_batch_occupancy`` histogram across every
    replica/level series: device-call count, mean fill, p50 fill."""
    from mx_rcnn_tpu_torch import obs
    from mx_rcnn_tpu_torch.obs import metrics as metrics_mod

    snap = obs.histogram(
        "serve_batch_occupancy",
        "request slots filled / slots total per device call",
    ).snapshot()
    series = [s for s in snap.values() if s.get("count")]
    calls = sum(s["count"] for s in series)
    if not calls:
        return {"device_calls": 0, "mean": None, "p50": None}
    le = series[0]["le"]
    merged = [0] * len(le)
    for s in series:
        for i, c in enumerate(s["buckets"]):
            merged[i] += c
    return {
        "device_calls": calls,
        "mean": round(sum(s["sum"] for s in series) / calls, 4),
        "p50": round(
            metrics_mod.percentile_from_counts(le, merged, 0.50), 4
        ),
    }
