"""The port's HTTP edit service (nle_tpu_torch/serving/http.py) on the CPU:
every case of tests/test_serve_http.py that does not concern JAX, run
against the port with device="cpu", then both packages' servers side by
side on the same PNG and queries (status codes, JSON keys, error texts;
images >= 45 dB apart), a spill directory written by nle_tpu's store
recovered and served by the port's, and FactoredFilter.nbytes against
nle_tpu's.

Threads coordinate through events (never sleeps); the module caps torch's
CPU threads so that request threads do not oversubscribe the workers of a
parallel test run.
"""

import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nle_tpu_torch.serving import http as srv_mod
from nle_tpu_torch.serving.http import _CoalescingTrainer, _FilterStore

cv2 = pytest.importorskip("cv2")

CFG = "nr=4&nc=5&hx=50&hy=30&iters=5&k=4"
CFG3 = "nr=4&nc=5&hx=50&hy=30&iters=3&k=3"
PSNR_DB = 45.0    # the packages' images on one PNG and query


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _start(**kw):
    srv = srv_mod.make_server(**{"device": "cpu", **kw})
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    srv, base = _start()
    yield base
    srv.shutdown()


def _png_bytes(img_bgr):
    ok, buf = cv2.imencode(".png", img_bgr)
    assert ok
    return buf.tobytes()


def _decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.fixture(scope="module")
def small_png():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    return img, _png_bytes(img)


def _post(url, data, timeout=300, token=None):
    req = urllib.request.Request(url, data=data)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    return urllib.request.urlopen(req, timeout=timeout)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# -- the cases of tests/test_serve_http.py, against the port ---------------

def test_healthz(server):
    meta = _get_json(f"{server}/healthz")
    assert meta["ok"] and meta["platform"] == "cpu"
    assert "device_name" not in meta      # the card's name, on the card


def test_train_then_apply(server, small_png):
    img, png = small_png
    with _post(f"{server}/train?name=t1&{CFG}", png) as r:
        meta = json.loads(r.read())
    assert meta == {"name": "t1", "k": 4, "mode": "enhance",
                    "shape": [40, 50]}
    with _post(f"{server}/apply?name=t1&w=1,2,2,1", png) as r:
        assert r.headers["Content-Type"] == "image/png"
        out = _decode(r.read())
    assert out.shape == img.shape
    # one-shot /enhance with the same params gives the identical edit
    with _post(f"{server}/enhance?{CFG}&w=1,2,2,1", png) as r:
        out2 = _decode(r.read())
    np.testing.assert_array_equal(out, out2)


def test_denoise_roundtrip(server, small_png):
    img, png = small_png
    with _post(f"{server}/denoise?nr=4&nc=5&hx=50&hy=30&iters=3&k=3"
               "&shrink=2", png) as r:
        out = _decode(r.read())
    assert out.shape == img.shape


def test_errors_are_http_400(server, small_png):
    _, png = small_png
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{server}/apply?name=missing&w=1,1,1,1", png)
    assert ei.value.code == 400
    assert "missing" in json.loads(ei.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{server}/enhance?nr=4&nc=5&hx=50&hy=30", b"not an image")
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{server}/nope", png)
    assert ei.value.code == 404


def test_bad_content_length_is_http_400(server):
    import http.client

    host, port = server.removeprefix("http://").split(":")
    for bad in ("abc", "-5"):
        conn = http.client.HTTPConnection(host, int(port), timeout=10)
        try:
            conn.putrequest("POST", "/enhance?nr=2&nc=2&hx=50&hy=30")
            conn.putheader("Content-Length", bad)
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == 400
            assert "Content-Length" in json.loads(resp.read())["error"]
        finally:
            conn.close()


def test_concurrent_enhance_coalesces(server, small_png):
    """Concurrent same-shape /enhance requests each equal the sequential
    result, bit for bit."""
    img, png = small_png
    cfg = f"{CFG}&w=1,2,2,1"
    with _post(f"{server}/enhance?{cfg}", png) as r:
        want = r.read()
    results = [None] * 3

    def hit(i):
        with _post(f"{server}/enhance?{cfg}", png) as r:
            results[i] = r.read()
    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got in results:
        assert got == want


def test_coalescer_batches_queued_requests(small_png):
    """Requests queued while the worker is held drain as ONE batch
    (train_batches 1, batched_filters 3), each equal to a direct
    NLEFilter.train_and_enhance of its frame."""
    from nle_tpu_torch.models.filter import NLEFilter

    img, _ = small_png
    frames = [img, img[::-1].copy(), img[:, ::-1].copy()]
    params = (4, 5, 50.0, 30.0, 5, 4)
    svc = srv_mod._Service(device="cpu")
    trainer = svc.trainer
    gate, full = threading.Event(), threading.Event()
    real_drain = trainer._drain

    def gated_drain():
        gate.wait(60)
        real_drain()

    class Queue(list):
        def append(self, item):
            super().append(item)
            if len(self) == len(frames):
                full.set()

    trainer._drain = gated_drain
    trainer._queue = Queue()
    outs = [None] * len(frames)

    def go(i):
        flt, lab = trainer.train_enhancement(frames[i], params)
        f = NLEFilter(trained=flt, device="cpu")
        f.seed_lab_cache(frames[i], lab)
        outs[i] = f.enhance(frames[i], [1, 2, 2, 1])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(frames))]
    for t in threads:
        t.start()
    assert full.wait(60)
    gate.set()
    for t in threads:
        t.join(120)
    snap = svc.metrics.snapshot()
    assert (snap["train_batches"], snap["batched_filters"]) == (1, 3)
    for frame, out in zip(frames, outs):
        want = NLEFilter(device="cpu").train_and_enhance(
            frame, *params, weights=[1, 2, 2, 1])
        np.testing.assert_array_equal(out, want)


def test_metrics_endpoint(server, small_png):
    _, png = small_png
    with _post(f"{server}/enhance?{CFG3}&w=1,1,1,1", png) as r:
        r.read()
    m = _get_json(f"{server}/metrics")
    assert m["trains"] >= 1 and m["edits"] >= 1
    e = m["endpoints"]["/enhance"]
    assert e["count"] >= 1 and e["last_sec"] > 0 and "mean_sec" in e
    assert 0 < e["p50_sec"] <= e["p99_sec"]
    assert "_lat" not in e
    assert "resident" in m["filters"]
    # On the CPU: no data, not zero.
    assert m["device_memory"] == {}


def test_metrics_quantiles_window():
    m = srv_mod._Metrics()
    for i in range(2000):
        m.record("/x", 0.001 if i % 100 else 5.0, True)
    snap = m.snapshot()["endpoints"]["/x"]
    assert snap["p50_sec"] == 0.001
    assert snap["p99_sec"] == 5.0
    assert len(m.endpoints["/x"]["_lat"]) <= m._LAT_WINDOW


@pytest.fixture()
def locked_server(tmp_path):
    srv, base = _start(token="sekrit", max_bytes=1 << 20, max_filters=2,
                       spill_dir=str(tmp_path / "spill"))
    yield base
    srv.shutdown()


def test_auth_required(locked_server, small_png):
    _, png = small_png
    for tok in (None, "wrong"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"{locked_server}/train?name=a&{CFG3}", png, token=tok)
        assert ei.value.code == 401
    assert _get_json(f"{locked_server}/healthz")["ok"]
    with _post(f"{locked_server}/train?name=a&{CFG3}", png,
               token="sekrit") as r:
        assert json.loads(r.read())["k"] == 3
    assert _get_json(f"{locked_server}/metrics")["rejected"] >= 2


def test_request_size_limit(locked_server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{locked_server}/enhance?nr=2&nc=2&hx=50&hy=30",
              b"x" * (2 << 20), token="sekrit")
    assert ei.value.code == 413


def test_lru_eviction_spills_and_reloads(locked_server, small_png):
    """max_filters=2: a third filter spills the LRU one; /apply reloads it
    with the same bytes."""
    _, png = small_png
    for name in ("f1", "f2"):
        with _post(f"{locked_server}/train?name={name}&{CFG3}", png,
                   token="sekrit") as r:
            r.read()
    with _post(f"{locked_server}/apply?name=f1&w=1,2,2,1", png,
               token="sekrit") as r:
        want = r.read()
    with _post(f"{locked_server}/train?name=f3&{CFG3}", png,
               token="sekrit") as r:
        r.read()
    m = _get_json(f"{locked_server}/metrics")["filters"]
    assert (m["resident"], m["spilled"]) == (2, 1)
    assert m["evictions"] >= 1 and m["resident_bytes"] > 0
    assert _get_json(f"{locked_server}/healthz")["filters"] == \
        ["f1", "f2", "f3"]
    with _post(f"{locked_server}/apply?name=f2&w=1,2,2,1", png,
               token="sekrit") as r:
        got = r.read()
    assert got == want


def test_factored_query_param(server, small_png):
    img, png = small_png
    cfg = f"{CFG}&factored=1"
    with _post(f"{server}/train?name=vfree&{cfg}", png) as r:
        assert json.loads(r.read())["k"] == 4
    with _post(f"{server}/apply?name=vfree&w=1,2,2,1", png) as r:
        out = _decode(r.read())
    assert out.shape == img.shape
    with _post(f"{server}/enhance?{cfg}&w=1,2,2,1", png) as r:
        out2 = _decode(r.read())
    np.testing.assert_array_equal(out2, out)


class _FakeTrained:
    def __init__(self, fail=False):
        self.fail = fail
        self.saved = []

    def save(self, path):
        if self.fail:
            raise OSError("disk full")
        self.saved.append(path)
        with open(path, "wb") as f:
            f.write(b"ckpt")

    def to(self, device):
        return self


class _FakeFilter:
    def __init__(self, fail=False):
        self.trained = _FakeTrained(fail)


def test_lru_clean_eviction_skips_resave(tmp_path):
    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path / "s"))
    f1, f2 = _FakeFilter(), _FakeFilter()
    store.put("a", f1)
    store.put("b", f2)          # evicts a -> 1 save
    assert len(f1.trained.saved) == 1
    store._resident["a"] = f1
    store._on_disk.add("a")
    store._spilled.discard("a")
    with store._lock:
        victims = store._pick_victims_locked()
    store._save_victims(victims)
    assert len(f1.trained.saved) == 1
    store.put("a", f1)          # fresh training invalidates the checkpoint
    store.put("c", _FakeFilter())
    assert len(f1.trained.saved) == 2


def test_apply_denoise_op(server, small_png):
    img, png = small_png
    with _post(f"{server}/train?name=dn&{CFG}", png) as r:
        r.read()
    with _post(f"{server}/apply?name=dn&op=denoise&shrink=2", png) as r:
        assert _decode(r.read()).shape == img.shape
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{server}/apply?name=dn&op=sharpen", png)
    assert ei.value.code == 400


def test_train_mode_denoise_matches_oneshot(server, small_png):
    _, png = small_png
    with _post(f"{server}/train?name=dnm&mode=denoise&{CFG}", png) as r:
        assert json.loads(r.read())["mode"] == "denoise"
    with _post(f"{server}/apply?name=dnm&op=denoise&shrink=2", png) as r:
        out = _decode(r.read())
    with _post(f"{server}/denoise?{CFG}&shrink=2", png) as r:
        oneshot = _decode(r.read())
    np.testing.assert_array_equal(out, oneshot)
    with _post(f"{server}/train?name=dnm2&{CFG}", png) as r:
        r.read()
    with _post(f"{server}/apply?name=dnm2&op=denoise&shrink=2", png) as r:
        out_raw = _decode(r.read())
    assert not np.array_equal(out_raw, oneshot)
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{server}/train?name=bad&mode=sharpen&{CFG}", png)
    assert ei.value.code == 400


def test_access_log_lines(small_png):
    buf = io.StringIO()
    srv, base = _start(access_log=buf)
    try:
        _, png = small_png
        with _post(f"{base}/enhance?{CFG3}&w=1,1,1,1", png) as r:
            r.read()
        with pytest.raises(urllib.error.HTTPError):
            _post(f"{base}/nope", png)
    finally:
        srv.shutdown()
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert len(lines) == 2
    by_path = {x["path"].split("?")[0]: x for x in lines}
    ok = by_path["/enhance"]
    assert (ok["status"] == 200 and ok["ms"] > 0
            and ok["bytes_in"] == len(png)
            and ok["bytes_out"] > 0 and ok["method"] == "POST")
    assert by_path["/nope"]["status"] == 404


def test_coalescer_midbatch_failure_releases_trained(monkeypatch):
    import nle_tpu_torch.models.batch as batch_mod

    calls = {"n": 0}

    def fake_iter(channels, *params, **kwargs):
        calls["n"] += 1
        assert kwargs["device"] == torch.device("cpu")
        if calls["n"] == 1:
            yield "filter-0"
            raise RuntimeError("card fell over")
        for i in range(len(channels)):
            yield f"ok-{i}"

    monkeypatch.setattr(batch_mod, "train_filters_iter", fake_iter)
    trainer = _CoalescingTrainer(threading.Lock(), device="cpu")
    img = np.zeros((8, 9, 3), np.uint8)
    params = (2, 2, 50.0, 30.0, 2, 2)
    results = [None] * 3

    def hit(i):
        try:
            results[i] = trainer.train_enhancement(img, params)[0]
        except RuntimeError as e:
            results[i] = e
    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "a waiter was stranded"
    oks = [r for r in results if isinstance(r, str) and r.startswith("ok-")]
    got_filters = [r for r in results if r == "filter-0"]
    got_errors = [r for r in results if isinstance(r, RuntimeError)]
    assert got_filters or oks
    assert len(got_filters) + len(got_errors) + len(oks) == 3
    assert trainer.train_enhancement(img, params)[0] == "ok-0"


def test_apply_validates_before_decode(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{server}/apply?name=whatever&op=sharpen", b"notanimage")
    assert ei.value.code == 400
    assert "unknown op" in ei.value.read().decode()


def test_spill_save_failure_keeps_filter_resident(tmp_path):
    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path))
    a, b = _FakeFilter(fail=True), _FakeFilter()
    store.put("a", a)
    store.put("b", b)          # evicts a; its save fails; must not raise
    assert store.get("a") is a
    assert store.get("b") is b
    assert "a" not in store._on_disk
    assert "a" not in store._saving


def test_stale_spill_save_does_not_mark_on_disk(tmp_path):
    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path))
    old, new = _FakeFilter(), _FakeFilter()
    store.put("x", old)
    with store._lock:
        store._resident.pop("x")
        store._saving["x"] = old
        store._spilled.add("x")
    victims = [("x", old)]
    store.put("x", new)
    store._save_victims(victims)
    assert "x" not in store._on_disk
    assert old.trained.saved == []
    assert store.get("x") is new


def test_stalled_spill_save_cannot_overwrite_newer_checkpoint(tmp_path):
    class _HookLock:
        def __init__(self):
            self.hook = None

        def __enter__(self):
            hook, self.hook = self.hook, None
            if hook:
                hook()

        def __exit__(self, *a):
            return False

    lock = _HookLock()
    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path),
                         device_lock=lock)
    old, new, other = _FakeFilter(), _FakeFilter(), _FakeFilter()
    store.put("x", old)

    def world_moves_on():
        store.put("x", new)
        store.put("z", other)

    lock.hook = world_moves_on
    store.put("y", _FakeFilter())
    path = store._path("x")
    assert len(new.trained.saved) == 1
    assert new.trained.saved[0].startswith(path + ".tmp-")
    assert old.trained.saved == []
    assert "x" in store._on_disk
    assert "x" in store._spilled and "x" not in store._saving
    with open(path, "rb") as fh:
        assert fh.read() == b"ckpt"


def test_filter_store_concurrent_stress(tmp_path):
    """Real (tiny) TrainedFilters on the CPU, so spills write genuine npz
    checkpoints and reloads go through the port's loader."""
    from nle_tpu_torch.models.filter import NLEFilter, TrainedFilter

    def tiny_filter(tag: float):
        return NLEFilter(trained=TrainedFilter(
            eigvecs=torch.full((6, 2), tag), eigvals=torch.ones(2),
            nrows=2, ncols=3), device="cpu")

    store = _FilterStore(max_filters=2, spill_dir=str(tmp_path),
                         device_lock=threading.Lock(), device="cpu")
    names = [f"n{i}" for i in range(5)]
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for it in range(150):
                name = names[int(rng.integers(len(names)))]
                op = rng.integers(4)
                if op == 0:
                    store.put(name, tiny_filter(float(seed * 1000 + it)))
                elif op == 1:
                    try:
                        store.get(name)
                    except KeyError:
                        pass
                elif op == 3:
                    try:
                        store.delete(name)
                    except KeyError:
                        pass
                else:
                    store.names()
                    assert store.stats()["resident_bytes"] >= 0
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors, errors
    for name in store.names():
        assert (name in store._resident or name in store._saving
                or os.path.exists(store._path(name)))


def test_http_fuzz_malformed_requests_never_500(server, small_png):
    _, png = small_png
    tiny = np.random.default_rng(1).integers(0, 256, (8, 9, 3), np.uint8)
    tiny_png = _png_bytes(tiny)
    rng = np.random.default_rng(7)
    paths = ["/enhance", "/denoise", "/train", "/apply", "/nope"]
    params = ["", "nr=2&nc=2&hx=50&hy=30&iters=2&k=2", "nr=abc&nc=2",
              "nr=2", "w=1,2,x", "w=", "name=%00weird", "op=explode",
              "shrink=-1", "sigma_color=0", "factored=maybe", "k=-3",
              "nr=0&nc=0&hx=50&hy=30", "nr=99&nc=99&hx=50&hy=30"]
    bodies = [b"", b"garbage", tiny_png, png[:40]]
    seen_500 = []
    for _ in range(60):
        path = paths[int(rng.integers(len(paths)))]
        q = params[int(rng.integers(len(params)))]
        body = bodies[int(rng.integers(len(bodies)))]
        url = f"{server}{path}" + (f"?{q}" if q else "")
        try:
            with _post(url, body, timeout=120) as r:
                assert r.status == 200
        except urllib.error.HTTPError as e:
            if e.code >= 500:
                seen_500.append((url, len(body), e.code, e.read()[:200]))
            e.read()
    assert not seen_500, seen_500
    with _post(f"{server}/enhance?nr=2&nc=2&hx=50&hy=30&iters=2&k=2"
               "&w=1,1", tiny_png) as r:
        assert r.status == 200


def _delete(base, name, token=None):
    req = urllib.request.Request(f"{base}/filters?name={name}",
                                 method="DELETE")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    return urllib.request.urlopen(req, timeout=30)


def test_delete_filter(server, small_png):
    _, png = small_png
    with _post(f"{server}/train?name=zap&{CFG3}", png) as r:
        r.read()
    with _delete(server, "zap") as r:
        assert json.loads(r.read())["deleted"] == "zap"
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"{server}/apply?name=zap&w=1,1", png)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        _delete(server, "zap")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(
            f"{server}/nope?name=zap", method="DELETE"), timeout=30)
    assert ei.value.code == 404
    eps = _get_json(f"{server}/metrics")["endpoints"]
    assert eps["/filters"]["count"] >= 2 and eps["/filters"]["errors"] >= 1


def test_delete_requires_auth(locked_server, small_png):
    _, png = small_png
    with _post(f"{locked_server}/train?name=d&{CFG3}", png,
               token="sekrit") as r:
        r.read()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _delete(locked_server, "d")
    assert ei.value.code == 401
    with _delete(locked_server, "d", token="sekrit") as r:
        assert json.loads(r.read())["deleted"] == "d"


def test_delete_removes_spilled_checkpoint(tmp_path):
    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path))
    store.put("a", _FakeFilter())
    store.put("b", _FakeFilter())
    store.delete("a")
    assert store.names() == ["b"]
    assert not list(tmp_path.glob("*"))
    assert _FilterStore(max_filters=1,
                        spill_dir=str(tmp_path)).names() == []


class _SizedTrained(_FakeTrained):
    def __init__(self, nb):
        super().__init__(False)
        self._nb = nb

    def nbytes(self):
        return self._nb


class _SizedFilter:
    def __init__(self, nb):
        self.trained = _SizedTrained(nb)


def test_byte_budget_evicts_by_bytes(tmp_path):
    budget = 100 << 20
    small, large = 4 << 20, 40 << 20
    store = _FilterStore(max_filters=100, spill_dir=str(tmp_path),
                         max_bytes=budget)
    sizes = {}
    for i in range(30):
        nb = large if i % 3 == 0 else small
        sizes[f"f{i}"] = nb
        store.put(f"f{i}", _SizedFilter(nb))
        st = store.stats()
        assert st["resident_bytes"] <= budget, (i, st)
    st = store.stats()
    assert st["evictions"] > 0
    assert st["resident"] + st["spilled"] == 30
    assert sorted(store.names()) == sorted(sizes)
    store2 = _FilterStore(max_filters=2, spill_dir=str(tmp_path / "s2"),
                          max_bytes=budget)
    for i in range(5):
        store2.put(f"g{i}", _SizedFilter(small))
    assert store2.stats()["resident"] == 2


def test_byte_budget_all_names_stay_servable(tmp_path, monkeypatch):
    from nle_tpu_torch.models import filter as filter_mod

    store = _FilterStore(max_filters=100, spill_dir=str(tmp_path),
                         max_bytes=10 << 20, device="cpu")
    for i in range(4):
        store.put(f"f{i}", _SizedFilter(6 << 20))
    assert store.stats()["resident"] == 1
    monkeypatch.setattr(filter_mod, "load_filter_host", lambda path: {})
    monkeypatch.setattr(filter_mod, "filter_from_host",
                        lambda arrays, device: _SizedTrained(6 << 20))
    for i in range(4):
        assert store.get(f"f{i}") is not None
        assert store.stats()["resident_bytes"] <= 10 << 20


def test_metrics_report_resident_bytes(server, small_png):
    _, png = small_png
    with _post(f"{server}/train?name=bytes1&{CFG3}", png) as r:
        r.read()
    filters = _get_json(f"{server}/metrics")["filters"]
    assert 0 < filters["resident_bytes"] < (1 << 20) * filters["resident"]
    assert "evictions" in filters and "max_bytes" in filters


def test_trained_filter_nbytes_accounting():
    from nle_tpu_torch.models.factored import FactoredFilter
    from nle_tpu_torch.models.filter import TrainedFilter

    n, k, p = 1000, 5, 16
    t = TrainedFilter(eigvecs=torch.zeros((n, k)), eigvals=torch.zeros(k),
                      nrows=25, ncols=40, perm=np.arange(n))
    base = n * k * 4 + k * 4 + n * 8 + n * 4     # perm and its int32 index
    assert t.nbytes() == base
    t.y_cache = (np.zeros(n, np.uint8), torch.zeros(n, dtype=torch.uint8))
    assert t.nbytes() == base + 2 * n
    f = FactoredFilter(
        y_train=np.zeros(n, np.uint8), c=torch.zeros(n),
        v_head=torch.zeros((p, k)), w=torch.zeros((p, k)),
        eigvals=torch.zeros(k), nrows=25, ncols=40, hx=10.0, hy=10.0,
        perm=np.arange(n))
    assert f.nbytes() == n + n * 8 + n * 4 + 2 * p * k * 4 + k * 4 + 3 * n * 4


def test_delete_without_spill_dir_stays_dirless():
    store = _FilterStore(max_filters=8, spill_dir=None)
    store.put("a", _FakeFilter())
    store.delete("a")
    assert store._spill_dir is None
    assert store.names() == []


def test_delete_racing_retrain_keeps_new_checkpoint(tmp_path):
    fired = []

    class HookLock:
        def __init__(self):
            self._l = threading.RLock()
            self.hook = None

        def __enter__(self):
            if self.hook is not None and not fired:
                fired.append(1)
                self.hook()
            self._l.acquire()
            return self

        def __exit__(self, *a):
            self._l.release()

    lock = HookLock()
    store = _FilterStore(max_filters=8, spill_dir=str(tmp_path),
                         device_lock=lock)
    old, new = _FakeFilter(), _FakeFilter()
    store.put("x", old)
    store.checkpoint_all()

    def retrain():
        store.put("x", new)
        store.checkpoint_all()

    lock.hook = retrain
    store.delete("x")
    assert fired
    assert store.get("x") is new
    assert (tmp_path / (store._stem("x") + ".npz")).exists()
    assert _FilterStore(max_filters=8,
                        spill_dir=str(tmp_path)).names() == ["x"]


def test_reload_racing_delete_raises_keyerror(tmp_path, monkeypatch):
    from nle_tpu_torch.models import filter as filter_mod

    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path))
    store.put("a", _FakeFilter())
    store.put("b", _FakeFilter())
    real_load = filter_mod.load_filter_host

    def load_after_delete(path):
        store.delete("a")
        return real_load(path)

    monkeypatch.setattr(filter_mod, "load_filter_host", load_after_delete)
    with pytest.raises(KeyError):
        store.get("a")


def test_delete_with_body_keeps_connection_in_sync(server, small_png):
    import http.client

    _, png = small_png
    with _post(f"{server}/train?name=db&{CFG3}", png) as r:
        r.read()
    host, port = server.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        body = b"GET /healthz HTTP/1.1\r\n\r\n" * 4
        conn.request("DELETE", "/filters?name=db", body=body)
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["deleted"] == "db"
        try:
            conn.request("GET", "/healthz")
            resp2 = conn.getresponse()
            assert resp2.status == 200
            assert json.loads(resp2.read())["ok"]
        except (http.client.HTTPException, OSError):
            pass  # a clean close also keeps the stream in sync
    finally:
        conn.close()


def test_checkpoint_all_then_warm_restart(tmp_path):
    store = _FilterStore(max_filters=8, spill_dir=str(tmp_path))
    store.put("a", _FakeFilter())
    store.put("b", _FakeFilter())
    assert store.checkpoint_all() == 2
    assert store.checkpoint_all() == 0
    assert _FilterStore(max_filters=8,
                        spill_dir=str(tmp_path)).names() == ["a", "b"]


def test_checkpoint_all_covers_inflight_eviction(tmp_path):
    store = _FilterStore(max_filters=8, spill_dir=str(tmp_path))
    f = _FakeFilter()
    store._saving["x"] = f
    store._spilled.add("x")
    assert store.checkpoint_all() == 1
    assert _FilterStore(max_filters=8,
                        spill_dir=str(tmp_path)).names() == ["x"]


def test_spill_dir_warm_restart(tmp_path, monkeypatch):
    from nle_tpu_torch.models import filter as filter_mod

    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path))
    store.put("scene/1?x=%00", _FakeFilter())
    store.put("b", _FakeFilter())
    assert "scene/1?x=%00" in store.names()
    store2 = _FilterStore(max_filters=2, spill_dir=str(tmp_path),
                          device="cpu")
    assert store2.names() == ["scene/1?x=%00"]
    sentinel = _FakeTrained()
    seen = {}

    def from_host(arrays, device):
        seen["device"] = device
        return sentinel

    monkeypatch.setattr(filter_mod, "load_filter_host",
                        lambda path: ("host", path))
    monkeypatch.setattr(filter_mod, "filter_from_host", from_host)
    assert store2.get("scene/1?x=%00").trained is sentinel
    assert seen["device"] == "cpu"
    with pytest.raises(KeyError):
        store2.get("b")
    (tmp_path / ("f" * 40 + ".name")).write_text("mismatched")
    (tmp_path / "junk.name").write_text("x")
    (tmp_path / ("a" * 40 + ".name")).write_bytes(b"\xff\xfe\xfd")
    store3 = _FilterStore(max_filters=2, spill_dir=str(tmp_path))
    assert store3.names() == ["scene/1?x=%00"]


def test_reload_racing_retrain_returns_fresh_filter(tmp_path, monkeypatch):
    from nle_tpu_torch.models import filter as filter_mod

    store = _FilterStore(max_filters=1, spill_dir=str(tmp_path),
                         device="cpu")
    a0, a1, b1, b2 = (_FakeFilter() for _ in range(4))
    store.put("a", a0)
    store.put("b", b1)
    entered, gate = threading.Event(), threading.Event()
    loads = []

    def fake_load(path):
        loads.append(path)
        if len(loads) == 1:
            entered.set()
            gate.wait(10)
            return a0.trained
        return a1.trained

    monkeypatch.setattr(filter_mod, "load_filter_host", fake_load)
    monkeypatch.setattr(filter_mod, "filter_from_host", lambda t, d: t)
    result = {}
    t = threading.Thread(target=lambda: result.update(f=store.get("a")))
    t.start()
    assert entered.wait(10), "reader never reached load_filter_host"
    store.put("a", a1)
    store.put("b", b2)
    gate.set()
    t.join(10)
    assert not t.is_alive()
    assert result["f"].trained is a1.trained
    assert len(loads) == 2


def test_enhance_big_image_falls_back_to_streaming_path(small_png,
                                                        monkeypatch):
    """The predicate on real numbers for a 16 GB card (fits_pipeline reads
    the card's free memory; set here), then the fallback forced on a small
    image: the per-request path serves it."""
    import nle_tpu_torch.models.batch as batch_mod

    class _Shape:
        def __init__(self, h, w):
            self.shape = (h, w, 3)

    monkeypatch.setattr(batch_mod, "stream_bytes_limit",
                        lambda dev: int(16e9 / 2.1))
    too_big = srv_mod._Service._too_big_to_pipeline
    assert too_big(_Shape(2000, 2000), (20, 30, 100.0, 30.0, 10, 5),
                   device="cuda")
    assert not too_big(_Shape(40, 50), (3, 4, 100.0, 30.0, 5, 4),
                       device="cuda")
    # On the CPU stream mode always fits.
    assert not too_big(_Shape(2000, 2000), (20, 30, 100.0, 30.0, 10, 5),
                       device="cpu")
    monkeypatch.setattr(srv_mod._Service, "_too_big_to_pipeline",
                        staticmethod(lambda img, params, device: True))
    srv, base = _start()
    try:
        img, png = small_png
        with _post(f"{base}/enhance?nr=3&nc=4&hx=100&hy=30&iters=5&k=4"
                   "&w=2,3,4,1", png) as r:
            assert _decode(r.read()).shape == img.shape
        m = _get_json(f"{base}/metrics")
        assert m["endpoints"]["/enhance"]["count"] == 1
        assert (m["train_batches"], m["batched_filters"]) == (1, 1)
    finally:
        srv.shutdown()


def test_stalled_client_connection_times_out(monkeypatch):
    import socket
    import time as time_mod

    monkeypatch.setenv("NLE_SERVE_SOCKET_TIMEOUT", "1")
    srv, _ = _start()
    try:
        s = socket.create_connection(
            ("127.0.0.1", srv.server_address[1]), timeout=10)
        s.sendall(b"POST /enhance HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 100000\r\n\r\npartial")
        s.settimeout(10)
        t0 = time_mod.monotonic()
        data = b"x"
        while data:
            data = s.recv(4096)
        assert time_mod.monotonic() - t0 < 8
        s.close()
    finally:
        srv.shutdown()


def test_main_rejects_unknown_arguments(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--tokn=secret"])
    with pytest.raises(SystemExit) as e:
        srv_mod.main()
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "unknown argument" in err and "--tokn=secret" in err
    assert "--reuse-delta" in err and "different clients" in err
    monkeypatch.setattr(sys, "argv", ["serve", "--device=tpu"])
    with pytest.raises(SystemExit) as e:
        srv_mod.main()
    assert e.value.code == 2


def test_parse_warmup_spec(monkeypatch):
    parse = srv_mod.parse_warmup_spec
    assert parse("64,48,3,4") == (64, 48, 3, 4, 10, 5)
    assert parse("1024,1024,20,30,50") == (1024, 1024, 20, 30, 50, 5)
    assert parse("100,200,8,10,12,7") == (100, 200, 8, 10, 12, 7)
    for bad in ("64,48,3", "a,b,c,d", "64,48,3,4,5,6,7", "64,0,3,4", ""):
        with pytest.raises(ValueError):
            parse(bad)
    monkeypatch.setattr(sys, "argv", ["serve", "--warmup=1024x768"])
    with pytest.raises(SystemExit) as e:
        srv_mod.main()
    assert e.value.code == 2


def test_run_warmup_drives_request_path():
    times = srv_mod.run_warmup([(48, 64, 3, 4, 5, 4)], device="cpu")
    assert len(times) == 1 and times[0] > 0
    srv, base = _start()
    try:
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
        with _post(f"{base}/enhance?nr=3&nc=4&iters=5&k=4&hx=500&hy=10"
                   "&w=2,3,4,1", _png_bytes(img), timeout=120) as r:
            assert _decode(r.read()).shape == img.shape
    finally:
        srv.shutdown()


def test_coalescing_trainer_reuse_delta():
    """Near-identical frames queued into one batch share a filter; distinct
    frames keep their own; without reuse_delta nothing is shared. The
    batch is formed by holding the worker until every request queued."""
    rng = np.random.default_rng(21)
    base = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    near = np.clip(base.astype(np.int16) + 1, 0, 255).astype(np.uint8)
    far = rng.integers(0, 256, (30, 40, 3)).astype(np.uint8)
    params = (4, 5, 40.0, 20.0, 6, 4)

    def run_batch(pairs, trainer):
        gate, full = threading.Event(), threading.Event()
        real_drain = trainer._drain

        class Queue(list):
            def append(self, item):
                super().append(item)
                if len(self) == len(pairs):
                    full.set()

        def gated():
            gate.wait(60)
            real_drain()

        trainer._drain = gated
        trainer._queue = Queue()
        results = {}

        def go(name, img):
            results[name] = trainer.train_enhancement(img, params)[0]

        threads = [threading.Thread(target=go, args=p) for p in pairs]
        for t in threads:
            t.start()
        assert full.wait(60)
        gate.set()
        for t in threads:
            t.join(timeout=120)
        trainer._drain = real_drain
        return results

    trainer = _CoalescingTrainer(threading.Lock(), reuse_delta=3.0,
                                 device="cpu")
    r = run_batch([("base", base), ("near", near)], trainer)
    assert r["near"] is r["base"]
    r = run_batch([("base", base), ("far", far)], trainer)
    assert r["far"] is not r["base"]
    trainer0 = _CoalescingTrainer(threading.Lock(), device="cpu")
    r = run_batch([("base", base), ("near", near)], trainer0)
    assert r["near"] is not r["base"]


# -- what only the port shows ----------------------------------------------

def test_card_is_the_default_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for make in (lambda: srv_mod.make_server(),
                 lambda: srv_mod._Service(),
                 lambda: _CoalescingTrainer(threading.Lock())):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_kernel_failure_is_a_500_with_a_logged_traceback(small_png,
                                                         monkeypatch,
                                                         caplog):
    """A device fault fails its request with a 500 (and a logged
    traceback); the server keeps serving."""
    from nle_tpu_torch.models import filter as filter_mod

    def boom(self, *a, **k):
        raise RuntimeError("CUDA kernel affinity_matmul failed to launch")

    srv, base = _start()
    try:
        _, png = small_png
        monkeypatch.setattr(filter_mod.NLEFilter, "train_for_denoise", boom)
        with caplog.at_level("ERROR", logger="nle_tpu_torch"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{base}/denoise?{CFG3}", png)
        assert ei.value.code == 500
        assert "failed to launch" in json.loads(ei.value.read())["error"]
        assert any(r.exc_info for r in caplog.records)
        monkeypatch.undo()
        with _post(f"{base}/denoise?{CFG3}", png) as r:
            assert r.status == 200
    finally:
        srv.shutdown()


# -- both packages side by side --------------------------------------------

@pytest.fixture(scope="module")
def both_servers():
    from nle_tpu.serving.http import make_server as jax_make_server

    jsrv = jax_make_server()
    threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    tsrv, tbase = _start()
    yield f"http://127.0.0.1:{jsrv.server_address[1]}", tbase
    jsrv.shutdown()
    tsrv.shutdown()


def _call(base, method, path, body=None):
    """(status, content type, body bytes) of one request."""
    req = urllib.request.Request(f"{base}{path}", data=body, method=method)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


PARITY_REQUESTS = [
    ("POST", f"/train?name=p1&{CFG}", "png"),
    ("POST", "/apply?name=p1&w=1,2,2,1", "png"),
    ("POST", f"/enhance?{CFG}&w=2,3,4,1", "png"),
    ("POST", f"/denoise?{CFG}&shrink=2", "png"),
    ("POST", f"/train?name=p2&mode=denoise&{CFG}", "png"),
    ("POST", "/apply?name=p2&op=denoise&shrink=2", "png"),
    ("POST", "/apply?name=missing&w=1,1", "png"),
    ("POST", f"/enhance?{CFG}", "garbage"),
    ("POST", "/enhance?nr=abc&nc=2", "png"),
    ("POST", "/apply?name=p1&op=sharpen", "garbage"),
    ("POST", f"/train?name=bad&mode=sharpen&{CFG}", "png"),
    ("POST", "/nope", "png"),
    ("DELETE", "/filters?name=p2", None),
    ("DELETE", "/filters?name=p2", None),
    ("GET", "/nope", None),
]


def test_both_servers_answer_alike(both_servers, small_png):
    """Same status codes and content types; the same /train JSON; the same
    error texts; images >= 45 dB apart."""
    jbase, tbase = both_servers
    _, png = small_png
    bodies = {"png": png, "garbage": b"not an image", None: None}
    for method, path, body in PARITY_REQUESTS:
        js, jtype, jout = _call(jbase, method, path, bodies[body])
        ts, ttype, tout = _call(tbase, method, path, bodies[body])
        assert (js, jtype) == (ts, ttype), (method, path)
        if jtype == "image/png":
            db = _psnr(_decode(jout), _decode(tout))
            assert db >= PSNR_DB, (path, db)
        else:
            assert json.loads(jout) == json.loads(tout), (method, path)


def test_both_servers_report_the_same_keys(both_servers, small_png):
    jbase, tbase = both_servers
    _, png = small_png
    for base in both_servers:
        _call(base, "POST", f"/enhance?{CFG3}&w=1,1,1,1", png)
    jh, th = _get_json(f"{jbase}/healthz"), _get_json(f"{tbase}/healthz")
    assert set(jh) == set(th)
    assert jh["platform"] == th["platform"] == "cpu"
    jm, tm = _get_json(f"{jbase}/metrics"), _get_json(f"{tbase}/metrics")
    assert set(jm) == set(tm)
    assert set(jm["filters"]) == set(tm["filters"])
    assert (set(jm["endpoints"]["/enhance"])
            == set(tm["endpoints"]["/enhance"]))
    # Neither CPU backend reports device memory: no data, not zero.
    assert jm["device_memory"] == tm["device_memory"] == {}


def test_port_serves_a_spill_directory_written_by_nle_tpu(tmp_path,
                                                          small_png):
    """nle_tpu's store checkpoints a dense and a factored filter; the
    port's server, started on that --spill-dir, lists and serves them:
    /apply >= 45 dB from nle_tpu's edit with the same filter (in practice
    the same bytes up to the apply's fp32 sums)."""
    from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
    from nle_tpu.serving.http import _FilterStore as JaxStore

    img, png = small_png
    jstore = JaxStore(max_filters=8, spill_dir=str(tmp_path))
    want = {}
    for name, factored in (("scene/dense", False), ("vfree", True)):
        f = JaxNLEFilter(factored=True) if factored else JaxNLEFilter()
        f.train_for_enhancement(img, 4, 5, 50.0, 30.0, 5, 4)
        jstore.put(name, f)
        want[name] = f.enhance(img, [1, 2, 2, 1])
    assert jstore.checkpoint_all() == 2
    srv, base = _start(spill_dir=str(tmp_path))
    try:
        assert _get_json(f"{base}/healthz")["filters"] == \
            ["scene/dense", "vfree"]
        for name, ref in want.items():
            with _post(f"{base}/apply?name={name}&w=1,2,2,1", png) as r:
                got = _decode(r.read())
            assert _psnr(got, ref) >= PSNR_DB, name
    finally:
        srv.shutdown()


def test_factored_nbytes_equals_nle_tpu(tmp_path, small_png):
    """The byte budget counts a factored filter as nle_tpu does: the same
    filter (trained by nle_tpu, loaded by the port) has the same nbytes."""
    from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
    from nle_tpu_torch.models.filter import load_filter

    img, _ = small_png
    f = JaxNLEFilter(factored=True)
    f.train_for_enhancement(img, 4, 5, 50.0, 30.0, 5, 4)
    path = str(tmp_path / "f.npz")
    f.trained.save(path)
    assert load_filter(path, "cpu").nbytes() == f.trained.nbytes()


def test_check_serving_tool_on_cpu():
    """The serving load check (nle_tpu_torch/tools/check_serving.py) at a
    small size: concurrent responses bitwise the library, the byte-copy
    pair byte-identical, the requests coalesced."""
    from nle_tpu_torch.tools import check_serving as cs

    imgs = cs.frames(cs.structured_frame(40, 50), 4)
    assert np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[0], imgs[2])
    res = cs.run(imgs, "cpu", params=(4, 5, 50.0, 30.0, 5, 4),
                 weights=(1, 2, 2, 1))
    assert res["ok"], res
    assert res["exact"] == [True] * 4 and res["peak_device_bytes"] is None
    assert cs.main(["--n=2", "--device=cpu"]) == 2
    assert cs.main(["--bogus"]) == 2


def test_launch_counts_survive_concurrent_threads():
    """Request threads count kernel launches side by side: no increment is
    lost (a short switch interval makes an unguarded += lose some)."""
    from nle_tpu_torch.ops.kernels import _build

    before = sys.getswitchinterval()
    saved = dict(_build.LAUNCHES)
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launches()

        def work():
            for _ in range(5000):
                _build.count_launch("affinity_matmul")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert _build.LAUNCHES["affinity_matmul"] == 16 * 5000
    finally:
        sys.setswitchinterval(before)
        _build.LAUNCHES.update(saved)
