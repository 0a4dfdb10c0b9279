"""The port's serving pool (nle_tpu_torch/serving/pool.py) on the CPU: the
cases of tests/test_serve_pool.py over real worker processes of the port's
HTTP service (`--device=cpu`), and the name hash that keeps named traffic
on one worker, equal to nle_tpu's."""

import json
import sys
import threading
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest

from nle_tpu_torch.serving import pool as P

cv2 = pytest.importorskip("cv2")

CFG = "nr=4&nc=5&hx=50&hy=30&iters=3&k=3"
# Workers are separate processes: cap their CPU threads so that a parallel
# test run is not oversubscribed.
WORKER_ENV = {"OMP_NUM_THREADS": "2"}


@pytest.fixture(scope="module")
def pool_server(tmp_path_factory):
    spill_root = str(tmp_path_factory.mktemp("pool-spill"))
    pool = P.WorkerPool(2, ["--device=cpu"], spill_root=spill_root,
                        worker_env=WORKER_ENV)
    pool.start()
    srv = P.make_pool_server(pool, max_bytes=1 << 20)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", pool
    srv.shutdown()
    pool.stop()


@pytest.fixture(scope="module")
def small_png():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".png", img)
    assert ok
    return img, buf.tobytes()


def _post(url, data, timeout=300):
    return urllib.request.urlopen(
        urllib.request.Request(url, data=data), timeout=timeout)


def _decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def test_pool_healthz(pool_server):
    base, pool = pool_server
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["ok"] and meta["workers"] == 2
    for w in pool.workers:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{w.port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["platform"] == "cpu"


def test_pool_round_robin_enhance(pool_server, small_png):
    base, pool = pool_server
    _, png = small_png
    outs = []
    for _ in range(4):
        with _post(f"{base}/enhance?{CFG}&w=1,2,2,1", png) as r:
            outs.append(r.read())
    assert all(o == outs[0] for o in outs)   # deterministic, bit for bit
    counts = []
    for w in pool.workers:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{w.port}/metrics", timeout=30) as r:
            m = json.loads(r.read())
        counts.append(m["endpoints"].get("/enhance", {}).get("count", 0))
    assert all(c >= 1 for c in counts), counts


def test_pool_sticky_named_filters(pool_server, small_png):
    base, pool = pool_server
    img, png = small_png
    for name in ("alpha", "beta", "gamma"):
        with _post(f"{base}/train?name={name}&{CFG}", png) as r:
            assert json.loads(r.read())["name"] == name
        with _post(f"{base}/apply?name={name}&w=1,2,2,1", png) as r:
            assert _decode(r.read()).shape == img.shape
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        names = json.loads(r.read())["filters"]
    assert {"alpha", "beta", "gamma"} <= set(names)
    # Each name lives on the worker pick() names, and only there.
    for name in ("alpha", "beta", "gamma"):
        owner = pool.pick("/train", f"name={name}")
        for w in pool.workers:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{w.port}/healthz", timeout=30) as r:
                held = name in json.loads(r.read())["filters"]
            assert held == (w is owner), (name, w.idx)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{base}/apply?name=nope&w=1,1", png)
    assert ei.value.code == 400
    req = urllib.request.Request(f"{base}/filters?name=gamma",
                                 method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert json.loads(r.read())["deleted"] == "gamma"


def test_pool_metrics_aggregate(pool_server, small_png):
    base, _ = pool_server
    _, png = small_png
    with _post(f"{base}/enhance?{CFG}&w=1,1,1,1", png) as r:
        r.read()
    with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
        m = json.loads(r.read())
    assert m["trains"] >= 1 and m["edits"] >= 1
    assert len(m["workers"]) == 2
    assert "resident_bytes" in m
    assert all(b["device_memory"] == {} for b in m["workers"])


def test_pool_front_door_size_limit(pool_server):
    base, _ = pool_server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{base}/enhance?{CFG}", b"x" * (2 << 20))
    assert ei.value.code == 413


def test_pool_auth_passthrough(small_png):
    _, png = small_png
    pool = P.WorkerPool(1, ["--device=cpu", "--token=sek"],
                        worker_env=WORKER_ENV)
    pool.start()
    srv = P.make_pool_server(pool)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{base}/enhance?{CFG}&w=1,1", png)
        assert ei.value.code == 401
        req = urllib.request.Request(f"{base}/enhance?{CFG}&w=1,1",
                                     data=png)
        req.add_header("Authorization", "Bearer sek")
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
    finally:
        srv.shutdown()
        pool.stop()


def test_pool_delete_bad_content_length(pool_server):
    import http.client

    base, _ = pool_server
    host, port = base.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("DELETE", "/filters?name=x")
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "Content-Length" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_pool_worker_env_substitution():
    pool = P.WorkerPool(3, [], worker_env={"CUDA_VISIBLE_DEVICES": "{i}"})
    assert [w.env_extra["CUDA_VISIBLE_DEVICES"] for w in pool.workers] == \
        ["0", "1", "2"]


def test_pool_router_fuzz_no_5xx_or_desync(pool_server, small_png):
    _, png = small_png
    probes = [
        ("POST", "/enhance", b"not an image"),
        ("POST", "/enhance?nr=x&nc=2&hx=1&hy=1", png),
        ("POST", "/apply?name=%00%ff&w=1", png),
        ("POST", "/nope", png),
        ("POST", "/train?nr=2", png),
    ]
    base, _ = pool_server
    for method, path, body in probes:
        req = urllib.request.Request(f"{base}{path}", data=body,
                                     method=method)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=120)
        body_out = ei.value.read()
        assert 400 <= ei.value.code < 500, (path, ei.value.code,
                                            body_out[:200])
        assert "error" in json.loads(body_out), body_out[:200]
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"]


def test_pool_worker_restart_recovers_filters(pool_server, small_png):
    """SIGTERM a worker that holds a named filter: it checkpoints to its
    spill dir, the supervisor restarts it, and /apply through the router
    gives the same bytes."""
    base, pool = pool_server
    _, png = small_png
    name = "sticky-restart"
    with _post(f"{base}/train?name={name}&{CFG}", png) as r:
        r.read()
    with _post(f"{base}/apply?name={name}&w=1,2,2,1", png) as r:
        want = r.read()
    w = pool.pick("/train", f"name={name}")
    old_proc = w.proc
    w.restarted.clear()
    w.terminate()
    old_proc.wait(timeout=60)
    assert w.restarted.wait(180), "supervisor did not restart the worker"
    assert w.alive() and w.proc is not old_proc
    with _post(f"{base}/apply?name={name}&w=1,2,2,1", png) as r:
        got = r.read()
    assert got == want
    assert pool.workers[w.idx].restarts >= 1


def test_pool_forwards_flags_to_workers(tmp_path):
    with mock.patch.object(sys, "argv", ["pool", "--warmup=bogus"]):
        assert P.main() == 2
    with mock.patch.object(sys, "argv", ["pool", "--device=tpu"]):
        assert P.main() == 2
    with mock.patch.object(sys, "argv", ["pool", "--platform=cpu"]):
        assert P.main() == 2      # the JAX package's flag is unknown here
    w = P._Worker(0, 41234, ["--warmup=32,48,3,4,4,3", "--device=cpu"],
                  str(tmp_path / "spill-0"))
    argv = w.build_argv()
    assert argv[1:3] == ["-m", "nle_tpu_torch.serving.http"]
    assert "--warmup=32,48,3,4,4,3" in argv and "--device=cpu" in argv
    assert "--port=41234" in argv
    assert f"--spill-dir={tmp_path / 'spill-0'}" in argv
    w2 = P._Worker(1, 41235, ["--reuse-delta=4", "--device=cpu"], None)
    assert "--reuse-delta=4" in w2.build_argv()


def test_pool_main_gives_workers_the_card_by_default(monkeypatch):
    """Without --device the workers get --device=cuda; a boot that fails
    stops every worker it started."""
    seen = {}

    class FakePool:
        def __init__(self, n, args, **kw):
            seen["args"] = list(args)
            self.stopped = False

        def start(self):
            raise RuntimeError("worker 0 exited rc=1 during startup")

        def stop(self):
            seen["stopped"] = True

    monkeypatch.setattr(P, "WorkerPool", FakePool)
    monkeypatch.setattr(sys, "argv", ["pool", "--workers=2"])
    with pytest.raises(RuntimeError, match="during startup"):
        P.main()
    assert seen["args"][-1] == "--device=cuda" and seen["stopped"]


def test_pool_ready_deadlines_scale_with_warmup_specs():
    plain = P.WorkerPool(1, ["--device=cpu"])
    assert not plain._warmup
    one = P.WorkerPool(1, ["--warmup=32,48,3,4", "--device=cpu"])
    assert one._warmup
    assert one._cold_deadline == 1800.0 and one._warm_deadline == 600.0
    three = P.WorkerPool(
        1, ["--warmup=32,48,3,4", "--warmup=64,48,3,4",
            "--warmup=32,64,3,4", "--device=cpu"])
    assert three._cold_deadline == 3 * 1800.0
    assert three._warm_deadline == 3 * 600.0
    forced = P.WorkerPool(1, ["--warmup=32,48,3,4"], ready_timeout=42.0)
    assert forced._cold_deadline == 42.0 and forced._warm_deadline == 42.0
    assert P.WorkerPool(1, [], ready_timeout=42.0)._plain_deadline == 42.0
    assert P.WorkerPool(1, [])._plain_deadline == 120.0


def test_pool_rejects_bad_ready_timeout():
    for bad in ("--ready-timeout=abc", "--ready-timeout=-5"):
        with mock.patch.object(sys, "argv", ["pool", bad]):
            assert P.main() == 2


@pytest.mark.parametrize("n_workers", [2, 3])
def test_pick_equals_nle_tpu(n_workers):
    """Named traffic goes to the worker index nle_tpu's pool picks, for 64
    names (so a spill root moves between the two pools unchanged)."""
    from nle_tpu.serving import pool as JP

    jpool, tpool = JP.WorkerPool(n_workers, []), P.WorkerPool(n_workers, [])
    names = [f"scene-{i}" for i in range(60)] + ["", "a/b?c", "%00", "ü"]
    for name in names:
        for path in ("/train", "/apply", "/filters"):
            q = f"name={name}"
            assert tpool.pick(path, q).idx == jpool.pick(path, q).idx
