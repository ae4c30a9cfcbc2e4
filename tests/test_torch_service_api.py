"""The port's HTTP front end (``repro_torch.service.api``) on the CPU,
against the JAX package's:

* the endpoints of the JAX package's ``test_http_api_roundtrip`` answer
  with the same JSON keys, and a campaign's front equals the JAX
  package's under ``hw=V5E``;
* bad specs are 400s, unknown campaigns 404s, ``/fleet/*`` 404s unless
  the fleet backend runs, ``/stats`` and ``/metrics`` carry the process
  pool's and the fleet's counters;
* ``python -m repro_torch.service --device cpu`` answers ``/healthz``,
  and without ``--device`` on a machine with no card it refuses to
  start;
* ``launch/dse_lm.py --service`` runs its campaign on the service.

Every campaign is the small spec of the JAX package's service tests."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.service import CampaignManager as RefCampaignManager
from repro.service.api import Client as RefClient
from repro.service.api import make_server as ref_make_server
from repro_torch.core.hw import V5E
from repro_torch.fleet import HttpError
from repro_torch.service import CampaignManager
from repro_torch.service.api import Client, make_server

from _torch_threads import bounded_torch_threads  # noqa: F401

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SMALL = dict(n_train=10, n_qor_samples=2, pop_size=8, n_parents=4,
             n_generations=2)


def _serve(mgr, make):
    srv = make(mgr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _roundtrip(cli, wait_timeout=600):
    """The JAX package's ``test_http_api_roundtrip`` walk, recording
    every response."""
    out = {"healthz": cli._req("/healthz")}
    cid = cli.submit(accel="mcm2", **SMALL)
    out["status"] = cli.wait(cid, timeout=wait_timeout)
    out["result"] = cli.result(cid)
    out["front"] = cli.front(cid)
    out["global_front"] = cli.global_front("mcm2")
    out["timeline"] = cli.timeline(cid)
    out["list"] = cli._req("/campaigns")
    out["stats"] = cli.stats()
    out["strategies"] = cli.strategies()
    out["health"] = cli.health()
    out["cid"] = cid
    return out


@pytest.fixture(scope="module")
def both():
    """The roundtrip on the port's service (CPU, the JAX package's cost
    model) and on the JAX package's."""
    runs = {}
    for name, mgr, make, client in (
            ("port", CampaignManager(eval_workers=2, campaign_workers=1,
                                     device="cpu", hw=V5E),
             make_server, Client),
            ("ref", RefCampaignManager(eval_workers=2, campaign_workers=1),
             ref_make_server, RefClient)):
        srv, base = _serve(mgr, make)
        try:
            runs[name] = _roundtrip(client(base))
        finally:
            srv.shutdown()
            mgr.shutdown()
    return runs


def test_http_api_roundtrip(both):
    got = both["port"]
    assert got["healthz"]["ok"]
    st = got["status"]
    assert st["state"] == "done"
    assert len(got["front"]["front"]) == st["front_size"]
    assert got["global_front"]["campaigns"] == [got["cid"]]
    assert got["stats"]["scheduler"]["requests"] > 0
    assert got["strategies"] == both["ref"]["strategies"]
    assert got["health"]["ok"]


@pytest.mark.parametrize("endpoint", ["healthz", "status", "result", "front",
                                      "global_front", "timeline", "health"])
def test_same_json_keys_as_reference(both, endpoint):
    assert set(both["port"][endpoint]) == set(both["ref"][endpoint])


def test_stats_carry_the_reference_sections(both):
    got, ref = both["port"]["stats"], both["ref"]["stats"]
    assert set(got) == set(ref)
    assert set(got["scheduler"]) == set(ref["scheduler"])
    assert set(both["port"]["list"][0]) == set(both["ref"]["list"][0])


def test_front_equals_reference_under_v5e(both):
    got, ref = both["port"], both["ref"]
    assert got["front"]["genomes"] == ref["front"]["genomes"]
    assert got["front"]["front"] == ref["front"]["front"]
    assert got["result"]["front"] == ref["result"]["front"]
    assert got["global_front"]["front"] == ref["global_front"]["front"]


def test_errors_and_fleet_routes():
    mgr = CampaignManager(eval_workers=1, campaign_workers=1, device="cpu",
                          eval_backend="process", process_workers=1)
    srv, base = _serve(mgr, make_server)
    cli = Client(base, retries=0)
    try:
        for bad in ({"accel": "nope"}, {"accel": "mcm2", "n_train": 0},
                    {"accel": "mcm2", "pop_size": 4, "n_parents": 8},
                    {"accel": "mcm2", "strategy": "nope"},
                    {"accel": "mcm2", "hierarchical": True}):
            with pytest.raises(HttpError, match="400"):
                cli._req("/campaigns", bad)
        with pytest.raises(HttpError, match="404"):
            cli.status("c9999-nope")
        with pytest.raises(HttpError, match="404"):
            cli._req("/fleet/stats")
        with pytest.raises(HttpError, match="404"):
            cli._req("/fleet/lease", {"worker": "w0"})
        with pytest.raises(HttpError, match="409"):
            cli.serve("mcm2", [[1, 2, 3, 4]], tier="exact")
        s = cli.stats()["scheduler"]
        assert s["backend"] == "process"
        assert s["labeler"]["workers"] == 1 and s["fleet"] is None
        assert "repro_sched_process_batches_total" in cli.metrics()
    finally:
        srv.shutdown()
        mgr.shutdown()


def test_fleet_routes_mounted_under_the_fleet_backend():
    mgr = CampaignManager(eval_workers=1, campaign_workers=1, device="cpu",
                          eval_backend="fleet")
    srv, base = _serve(mgr, make_server)
    cli = Client(base, retries=0)
    try:
        reg = cli._req("/fleet/register", {"worker": "w0", "accels": ["*"]})
        assert reg["ok"] and reg["worker"] == "w0"
        assert cli._req("/fleet/lease", {"worker": "w0"})["lease"] is None
        assert cli._req("/fleet/stats")["live"] == 1
        assert cli.stats()["scheduler"]["fleet"]["registered"] == 1
        assert cli.health()["fleet"]["live"] == 1
        assert "repro_fleet_live_workers" in cli.metrics()
        with pytest.raises(HttpError, match="400"):
            cli._req("/fleet/lease", [1, 2])
    finally:
        srv.shutdown()
        mgr.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_answers_healthz(tmp_path):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "--device", "cpu",
         "--port", str(port), "--store", str(tmp_path / "l.jsonl"),
         "--synth-cache", str(tmp_path / "s.jsonl"),
         "--snapshots", str(tmp_path / "snap.jsonl")],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": SRC})
    try:
        cli = Client(f"http://127.0.0.1:{port}", timeout=5, retries=0)
        deadline = time.monotonic() + 90
        while True:
            try:
                assert cli._req("/healthz") == {"ok": True}
                break
            except (HttpError, OSError):
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.monotonic() < deadline, "service never came up"
                time.sleep(0.2)
        st = cli.stats()
        assert st["scheduler"]["backend"] == "thread"
        assert st["synth"]["persistent"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_main_without_device_refuses_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "--port", "0",
         "--store", str(tmp_path / "l.jsonl"), "--snapshots", ""],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_dse_lm_service_runs_its_campaign_on_the_service(tmp_path, capsys):
    from repro_torch.launch import dse_lm

    mgr = CampaignManager(eval_workers=2, campaign_workers=1, device="cpu")
    srv, base = _serve(mgr, make_server)
    try:
        out = str(tmp_path / "o.json")
        res = dse_lm.main(["--service", base, "--n-train", "10",
                           "--generations", "2", "--pop", "8",
                           "--parents", "4", "--out", out])
        printed = capsys.readouterr().out
        assert "submitted to" in printed and "remote" in printed
        rec = json.loads(open(out).read())
        cid = rec["campaign"]
        assert mgr.status(cid)["state"] == "done"
        local = mgr.result(cid)
        assert rec["front"] == local.front_objectives.tolist()
        assert rec["front_genomes"] == local.front_genomes.tolist()
        assert res["front"] == rec["front"]
        assert mgr._get(cid).ctx.accel.device.type == "cpu"
        assert np.max(-np.asarray(rec["front"])[:, 0]) == 100.0
    finally:
        srv.shutdown()
        mgr.shutdown()
