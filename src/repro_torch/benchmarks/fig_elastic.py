"""Elastic topology timeline: kill -> drain -> recover -> re-add.

The paper's pooling endgame (§8): CXL devices come and go under a live
workload.  This benchmark drives the elastic runtime through the full
degraded-mode timeline and audits every leg:

Segment A (controller): Caption converges a weight vector on the
SNC-clipped fast tier + the three CXL devices (Table 1), then
  1. a FaultInjector bandwidth fault makes the EWMA slow-route drift
     detector re-open the converged walk (and restore re-converges it);
  2. a device kill silences its heartbeats, the HeartbeatMonitor flags
     it, and ``CaptionController.remove_device`` renormalizes the
     simplex over the survivors and re-converges;
  3. revive + ``add_device`` re-opens probing on the returned device's
     coordinate, and the walk lands back within 5pp per device of the
     pre-kill operating point.

Segment B (serving engine): a 3-device ServingEngine with a live
BulkMover loses a device mid-decode.  The drain ships the dead device's
KV pages through the bulk lane on real dead->survivor routes
(byte-for-byte checked against telemetry), the latency-SLO slot stays
pinned fast, no request is dropped, and the generated tokens are
IDENTICAL to a run with no kill at all.  After recovery the device is
re-added and serves again.  On the card the engine's pools are HBM and
page-locked host memory: the decode runs ``decode_attention`` and the
drain the default mover's ``stream_copy``.

``--smoke`` runs Segment B only (the CI fault-injection lane: kill +
recover one device on the 3-device preset); ``--out`` writes the rows
as a JSON artifact for the nightly trajectory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.benchmarks.fig8_dlrm import throughput_nd
from repro_torch.core import perfmodel
from repro_torch.core.caption import (CaptionConfig, CaptionController,
                                      EpochMetrics)
from repro_torch.core.mover import BulkMover
from repro_torch.core.policy import MemPolicy
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tiers import (CXL_A, CXL_B, CXL_C, DDR5_L8, OpClass,
                                    TierTopology)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.elastic import FaultInjector
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor, WorkerFailure

ARCH = "internvl2-2b"
THREADS = 32
MAX_EPOCHS = 512


def elastic_topology() -> TierTopology:
    """SNC-clipped fast node (Fig. 9 regime: interleaving helps) + the
    paper's three CXL devices — the pool the elastic runtime manages."""
    snc = dataclasses.replace(DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    return TierTopology(fast=snc, slows=(CXL_A, CXL_B, CXL_C))


# -- Segment A: controller timeline -------------------------------------------
def _tput(ctl: CaptionController, fast) -> float:
    """Throughput on the LIVE topology (degradations flow in through the
    perfmodel, so a FaultInjector fault is visible here automatically)."""
    return throughput_nd(fast, ctl.topology.slows, tuple(ctl.weights),
                         THREADS)


def _slow_bw(ctl: CaptionController) -> float:
    """Slow-route bandwidth proxy (the drift detector's counter signal)."""
    return sum(perfmodel.stream_bandwidth(d, OpClass.LOAD, 4)
               for d in ctl.topology.slows)


def _observe(ctl: CaptionController, fast):
    return ctl.observe(EpochMetrics(throughput=_tput(ctl, fast),
                                    slow_bw=_slow_bw(ctl)))


def _converge(ctl: CaptionController, fast, label: str) -> int:
    for epoch in range(MAX_EPOCHS):
        _observe(ctl, fast)
        if ctl.converged:
            return epoch
    raise AssertionError(f"{label}: no convergence in {MAX_EPOCHS} epochs")


def _by_name(ctl: CaptionController) -> dict[str, float]:
    return dict(zip(ctl.topology.slow_names, ctl.weights))


def run_controller_timeline() -> list[str]:
    rows = []
    topo = elastic_topology()
    mon = HeartbeatMonitor(timeout=2.5)
    ctl = CaptionController(
        topo, CaptionConfig(probe_epochs=2, step=0.05, min_step=0.01,
                            hysteresis=0.01, drift_threshold=0.15))
    with FaultInjector(mon) as inj:
        # 1. cold start -> converged operating point (the pre-kill anchor)
        e0 = _converge(ctl, topo.fast, "cold start")
        w0 = _by_name(ctl)
        rows.append(
            "fig_elastic/ctl/converged,0,"
            + f"epochs={e0};" + ";".join(f"{n}={w:.3f}"
                                         for n, w in w0.items())
            + f";tput={_tput(ctl, topo.fast):.0f}")

        # 2. bandwidth fault -> EWMA drift re-opens the walk
        _observe(ctl, topo.fast)  # establish the drift reference
        inj.degrade("cxl-a", bw_scale=0.4)
        drift_reason = None
        for epoch in range(8):
            d = _observe(ctl, topo.fast)
            if "drift" in d.reason:
                drift_reason = d.reason
                break
        assert drift_reason is not None, "degradation never tripped drift"
        assert not ctl.converged
        rows.append(f"fig_elastic/ctl/drift_reprobe,0,epoch={epoch};"
                    f"reason={drift_reason.split(';')[0]}")
        inj.restore("cxl-a")
        _converge(ctl, topo.fast, "post-restore")

        # 3. kill: heartbeats go silent -> monitor flags -> drain + re-seed
        inj.beat_alive(ctl.topology.slow_names, now=0.0)
        inj.kill("cxl-c")
        inj.beat_alive(ctl.topology.slow_names, now=3.0)
        try:
            mon.check(now=3.0)
            raise AssertionError("kill went undetected")
        except WorkerFailure as e:
            assert "cxl-c" in str(e)
        pre_kill_total = ctl.fraction
        ctl.remove_device("cxl-c")
        mon.remove("cxl-c")
        mon.check(now=3.0)  # recovery acknowledged: monitor unpoisoned
        assert ctl.topology.slow_names == ("cxl-a", "cxl-b")
        assert ctl.fraction <= pre_kill_total + 1e-9
        e1 = _converge(ctl, topo.fast, "survivors")
        wk = _by_name(ctl)
        rows.append(
            "fig_elastic/ctl/killed_reconverged,0,"
            + f"epochs={e1};" + ";".join(f"{n}={w:.3f}"
                                         for n, w in wk.items())
            + f";tput={_tput(ctl, topo.fast):.0f}")

        # 4. revive + re-add: probing re-opens on the returned coordinate
        inj.revive("cxl-c")
        ctl.add_device("cxl-c")
        assert ctl.active_slow_device == "cxl-c"
        e2 = _converge(ctl, topo.fast, "re-add")
        w2 = _by_name(ctl)
        rows.append(
            "fig_elastic/ctl/readded_converged,0,"
            + f"epochs={e2};" + ";".join(f"{n}={w:.3f}"
                                         for n, w in w2.items())
            + f";tput={_tput(ctl, topo.fast):.0f}")
        # Acceptance: the restored pool re-finds the pre-kill operating
        # point within 5pp per device.
        for name, w in w0.items():
            assert abs(w2[name] - w) <= 0.05, (name, w2[name], w)
    return rows


# -- Segment B: serving-engine drain audit -------------------------------------
def run_engine_drain(smoke: bool = False, device: DeviceLike = None,
                     params=None) -> list[str]:
    """``params`` defaults to ``module.init(cfg, 0)`` of internvl2-2b
    ``.tiny()`` on ``device``."""
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine

    device = resolve_device(device)
    rows = []
    topo = elastic_topology()
    arch = registry.get(ARCH).tiny()
    if params is None:
        params = arch.module.init(arch.cfg, 0, device=device)
    names = (topo.fast.name,) + topo.slow_names
    new_tokens = 6 if smoke else 12

    def build(tel, mover):
        return ServingEngine(
            arch.cfg, params, max_batch=2, max_len=32,
            policy=MemPolicy.weighted(names, (5, 1, 1, 1)),
            topology=topo, page_t=4, mover=mover, telemetry=tel,
            device=device)

    def serve(kill: bool):
        tel = Telemetry()
        mon = HeartbeatMonitor(timeout=1.5)
        audit = {"recovered": [], "drain_bytes": 0, "dead_pages": 0,
                 "step_s": {}}
        with BulkMover(topo, asynchronous=False, telemetry=tel,
                       device=device) as mover, \
                FaultInjector(mon) as inj:
            eng = build(tel, mover)
            eng.submit([5, 6, 7], max_new_tokens=new_tokens, slo="latency")
            for _ in range(2):
                eng.submit([5, 6, 7], max_new_tokens=new_tokens)
            steps = 0
            while eng.queue or any(eng.slots):
                steps += 1
                now = float(steps)
                eng.step()
                if steps == 2:
                    audit["step_s"]["pre_kill"] = eng.modeled_step_seconds()
                inj.beat_alive(topo.slow_names, now=now)
                if kill and steps == 3:
                    inj.kill("cxl-c")
                try:
                    mon.check(now=now)
                except WorkerFailure:
                    for name in mon.dead_workers(now=now):
                        dev = eng.cache.page_device.cpu().numpy()
                        audit["dead_pages"] = int((dev == 3).sum())
                        pre = {d: tel.route(name, d).bytes_moved
                               for d in names}
                        eng.remove_device(name, monitor=mon)
                        audit["drain_bytes"] = sum(
                            tel.route(name, d).bytes_moved - pre[d]
                            for d in names)
                        audit["recovered"].append(name)
                        audit["step_s"]["post_drain"] = \
                            eng.modeled_step_seconds()
                        # the SLO pin survived the drain untouched
                        dev = eng.cache.page_device.cpu().numpy()
                        assert (dev[0] == 0).all()
                        assert not (dev == 3).any()
            if kill:
                # recovery done: revive the device and re-add it live
                inj.revive("cxl-c")
                eng.add_device("cxl-c")
                eng.submit([5, 6, 7], max_new_tokens=new_tokens)
                eng.run_until_drained()
                audit["step_s"]["post_readd"] = eng.modeled_step_seconds()
            toks = sorted((r.rid, tuple(r.generated)) for r in eng.done)
            return eng, audit, toks

    eng, audit, toks_kill = serve(kill=True)
    _, _, toks_clean = serve(kill=False)

    # zero dropped requests; tokens bit-identical through the fault
    assert audit["recovered"] == ["cxl-c"]
    assert [t for t in toks_kill[:3]] == toks_clean, "tokens diverged"
    assert len(toks_kill) == 4  # incl. the post-re-add request
    assert all(len(t) == new_tokens for _, t in toks_kill)
    # page conservation: the drain billed exactly the dead population
    item = eng.cache.k_fast.dtype.itemsize
    L = eng.cache.k_fast.shape[0]
    K, hd = eng.cache.k_fast.shape[3:]
    page_kv_bytes = 2 * L * eng.cache.page_t * K * hd * item
    assert audit["dead_pages"] > 0
    assert audit["drain_bytes"] == audit["dead_pages"] * page_kv_bytes, \
        (audit["drain_bytes"], audit["dead_pages"], page_kv_bytes)
    # the pool healed end to end
    assert eng.topology.slow_names == topo.slow_names

    rows.append("fig_elastic/engine/kill_drain,0,"
                f"device=cxl-c;dead_pages={audit['dead_pages']};"
                f"drain_bytes={audit['drain_bytes']}")
    rows.append("fig_elastic/engine/recovered,0,"
                "requests=4;dropped=0;tokens_match=True")
    rows.append("fig_elastic/engine/timeline,0," + ";".join(
        f"{k}_step_us={v * 1e6:.2f}"
        for k, v in sorted(audit["step_s"].items())))
    return rows


def run(smoke: bool = False, device: DeviceLike = None,
        params=None) -> list[str]:
    """Segment B on ``device`` (the card unless told ``"cpu"``), after
    Segment A unless ``smoke``."""
    rows = run_engine_drain(smoke=smoke, device=device, params=params)
    if not smoke:
        rows = run_controller_timeline() + rows
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI lane: engine kill+recover on the 3-device "
                         "preset only")
    ap.add_argument("--out", default=None,
                    help="write rows as a JSON artifact")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        rows = run(smoke=args.smoke, device=args.device)
        ok = True
    except AssertionError as e:
        rows, ok = [f"fig_elastic/claims,0,CLAIM-FAILED: {e}"], False
    for row in rows:
        print(row)
    if ok:
        print("fig_elastic/claims,0,ALL-VALIDATED")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "ok": ok}, f, indent=2)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
