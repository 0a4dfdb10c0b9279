"""HTTP edit service: the train-once / edit-many flow over a real transport
(port of nle_tpu/serving/http.py onto the PyTorch model layer).

A stdlib ThreadingHTTPServer wrapping NLEFilter (models/filter.py). No
reference counterpart (the reference trains one filter per process run,
reference src/enhance.cpp:33-49); this is the deployment shape the
TrainedFilter checkpoint + apply CLI already support, exposed as a service.

Endpoints (image bytes in the request body, PNG bytes or JSON back):

    GET  /healthz                           liveness + device platform
    GET  /metrics                           request/latency/filter counters
    POST /enhance?nr=10&nc=20&hx=100&hy=30&iters=50&k=30&w=2,3,4,1
                                            one-shot train + enhance
    POST /denoise?...&shrink=2&sigma_color=10&sigma_space=10
                                            one-shot train + denoise
    POST /train?name=scene1&nr=..&nc=..     train a filter, keep it by name
                                            (mode=denoise trains on the
                                            bilateral-prefiltered L, the
                                            reference's trainForDenoise)
    POST /apply?name=scene1&w=2,3,4,1       edit with a kept filter
                                            (train once, edit many;
                                            op=denoise&shrink=2 runs the
                                            GLIDE application instead)
    DELETE /filters?name=scene1             drop a kept filter (memory,
                                            checkpoint, and sidecar)

Hardening:
  - request bodies above --max-bytes (default 64 MiB) are rejected with 413
    before any decode work;
  - --token=SECRET (or NLE_SERVE_TOKEN) requires `Authorization: Bearer
    SECRET` on every POST (GET /healthz & /metrics stay open — probes);
  - named filters live in a bounded LRU; residency is bounded by BYTES
    (--max-filter-bytes, default 4 GiB — each filter's host+device bytes
    are accounted via TrainedFilter/FactoredFilter.nbytes; filters vary
    ~1000x in size, so a count bound alone could exhaust the card) with
    --max-filters (default 8) as a secondary count cap; evicted filters
    SPILL to disk (TrainedFilter/FactoredFilter.save) and reload
    transparently on the next /apply — eviction degrades to a cold load,
    never to a 404. /metrics reports resident_bytes and evictions.

The service runs on one device, the card unless --device=cpu (device=
"cpu" for make_server); it raises without a card when the card is asked
for. Device work is serialized with a lock; decoding/encoding and the HTTP
plumbing run on the request threads (PNG encode happens OUTSIDE the device
lock). Every thread issues its device work to torch's default stream, so a
coalesced edit that runs outside the lock queues behind the training the
coalescer enqueued before it. A kernel that fails to build or launch fails
its request with a 500; nothing falls back to a plain version. Run:

    python -m nle_tpu_torch.serving.http [--port=8807] [--device=cuda|cpu]
        [--token=SECRET] [--access-log=PATH|-]
    curl -s --data-binary @image.png \
        'localhost:8807/enhance?nr=10&nc=20&hx=100&hy=30&iters=50&k=30&w=2,3,4,1' \
        -o enhanced.png

`--selftest` starts the server, POSTs the flower golden config through a
real socket, checks the PSNR gate, and exits.
"""

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from nle_tpu_torch.utils.imageio import imdecode_bgr as _decode_bgr
from nle_tpu_torch.utils.imageio import imencode_png as _encode_png

DEFAULT_MAX_BYTES = 64 << 20
DEFAULT_MAX_FILTERS = 8
DEFAULT_MAX_FILTER_BYTES = 4 << 30   # resident-filter byte budget (device+host)
_DRAIN_CAP = 8 << 20   # politeness-drain bound for rejected requests
# The reference's data directory (the JAX package's golden_configs.DATA_DIR):
# the selftest's flower golden pair.
REFERENCE_DATA = os.path.join(os.sep, "root", "reference", "data")


class _CoalescingTrainer:
    """Turns concurrent enhance-training requests into pipelined batches.

    Requests that arrive while the device is busy queue up; the worker
    drains every queued request whose (image shape, train params) match in
    ONE stream-mode call (models/batch.py train_filters_iter) — image
    i+1's stage 2a is queued on the device while image i's host-f64 chain
    runs. Mixed shapes/params fall back to per-request training within the
    same worker (device work stays serialized). Training runs on `device`
    (the card unless "cpu" is asked for)."""

    def __init__(self, device_lock: threading.Lock, metrics=None,
                 reuse_delta: float | None = None, *, device="cuda"):
        from nle_tpu_torch.config import resolve_device

        self.device = resolve_device(device)
        self._cv = threading.Condition()
        self._queue: list = []   # (key, L, params, result_box)
        self._worker: threading.Thread | None = None
        self._device_lock = device_lock
        self._metrics = metrics
        # OPT-IN temporal warm-start (--reuse-delta, models/batch.py
        # train_filters_iter): within a coalesced batch, frames whose
        # mean |L delta| vs the batch's last trained frame is under the
        # threshold reuse that filter — a burst of near-identical frames
        # trains once. NOT a default. The batch is keyed on shape and
        # train params only, not on the client: a coalesced batch may
        # share one filter across requests of different clients.
        self._reuse_delta = reuse_delta

    def train_enhancement(self, img_bgr, params):
        """Blocking: returns (TrainedFilter, lab) for img's Lab L channel
        (the lab array is handed back so the caller's edit can reuse the
        conversion via seed_lab_cache instead of converting again)."""
        from nle_tpu_torch.color.lab import bgr_to_lab_u8_np

        lab = bgr_to_lab_u8_np(img_bgr)
        L = lab[..., 0].astype(np.float32)
        key = (L.shape, params)
        box = {"event": threading.Event()}
        with self._cv:
            self._queue.append((key, L, params, box))
            # The worker clears self._worker UNDER this lock before
            # exiting, so checking it here cannot race with a worker that
            # already decided to die (which would strand this request).
            if self._worker is None:
                self._worker = threading.Thread(target=self._drain,
                                                daemon=True)
                self._worker.start()
        box["event"].wait()
        if "error" in box:
            raise box["error"]
        return box["filter"], lab

    def _drain(self):
        from nle_tpu_torch.models import batch as batch_mod

        while True:
            with self._cv:
                if not self._queue:
                    self._worker = None
                    return
                key = self._queue[0][0]
                group = [r for r in self._queue if r[0] == key]
                self._queue = [r for r in self._queue if r[0] != key]
            _, _, params, _ = group[0]
            done = 0
            try:
                # Hold the service's device lock while training: /train,
                # /denoise and factored /enhance train under it, and two
                # co-resident trainings can exceed the card's memory on
                # multi-MP images. Each request's box is released AS ITS
                # FILTER YIELDS (not after the whole batch): the request
                # thread's edit then queues on the default stream between
                # the next frames' device training.
                with self._device_lock:
                    for flt in batch_mod.train_filters_iter(
                            [r[1] for r in group], *params,
                            device=self.device,
                            reuse_delta=self._reuse_delta):
                        box = group[done][3]
                        box["filter"] = flt
                        box["event"].set()
                        done += 1
                if self._metrics is not None:
                    self._metrics.count_batch(len(group))
            except Exception as e:
                for _, _, _, box in group[done:]:
                    box["error"] = e
                    box["event"].set()


class _FilterStore:
    """Bounded LRU of named NLEFilters with disk spill.

    /train inserts; /apply looks up (touching recency). When the resident
    count exceeds `max_filters` the least-recently-used filter's state is
    saved to `spill_dir` (TrainedFilter/FactoredFilter.save — the same
    checkpoint format nle-apply consumes) and dropped from memory — its
    device buffers free with it. A later /apply for a spilled name reloads
    it (possibly evicting another), so capacity bounds memory, not the
    namespace.

    Warm restart: spill files are `sha1(name).npz` (URL names are not
    filesystem-safe) with the original name in a `.name` sidecar, so a
    restarted server pointed at the same --spill-dir recovers every
    previously spilled filter — checkpoint/resume for the serving
    namespace. The npz is the JAX package's format, so either package's
    server recovers the other's spill directory. Reloads land on `device`
    (models/filter.py load_filter's two halves)."""

    def __init__(self, max_filters: int = DEFAULT_MAX_FILTERS,
                 spill_dir: str | None = None,
                 device_lock=None,
                 max_bytes: int = DEFAULT_MAX_FILTER_BYTES,
                 device="cuda"):
        self.max_filters = max(1, int(max_filters))
        self.device = device
        # Byte budget over resident filters (host+device, via the filters'
        # own nbytes accounting). Filters vary ~1000x in size — a 5 MP k=50
        # TrainedFilter holds ~1 GB of V on the card — so the count bound
        # alone can exhaust the card with 8 large filters; bytes are the
        # real resource. The count cap stays as a secondary bound
        # (namespace hygiene).
        self.max_bytes = max(1, int(max_bytes))
        self._spill_dir = spill_dir
        self._lock = threading.Lock()
        # Spill saves fetch device buffers: serialize them with the
        # service's device lock so they never run concurrently with
        # another request's training/apply on the one device.
        self._device_lock = device_lock
        self._resident: OrderedDict[str, object] = OrderedDict()
        # Accounted bytes per resident name (filter.nbytes() at insert) and
        # a lifetime eviction counter — both surfaced via /metrics.
        self._bytes: dict[str, int] = {}
        self.evictions = 0
        # Per-name train generation, bumped by put(): a cold reload that
        # straddled a re-train must detect it (the checkpoint it np.load-ed
        # may predate the re-train) and retry instead of installing a
        # stale filter as authoritative.
        self._gen: dict[str, int] = {}
        # Evicted but not yet written to disk (save runs OUTSIDE the store
        # lock — it fetches ~100s of MB from the card): get() serves
        # these live objects so eviction is never observable as a miss.
        self._saving: dict[str, object] = {}
        self._spilled: set[str] = set()
        # Names whose on-disk checkpoint matches the resident filter
        # (i.e. reloaded-and-unmodified): evicting them skips the save —
        # filters are immutable post-train, so a round-robin /apply over
        # max_filters+1 names must not pay a device fetch + npz compress
        # per request.
        self._on_disk: set[str] = set()
        if spill_dir is not None:
            self._recover_spills()

    def _dir(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="nle-filters-")
        else:
            os.makedirs(self._spill_dir, exist_ok=True)
        return self._spill_dir

    @staticmethod
    def _stem(name: str) -> str:
        # Names come from URLs; keep the file name safe.
        import hashlib

        return hashlib.sha1(name.encode()).hexdigest()

    def _path(self, name: str) -> str:
        return os.path.join(self._dir(), self._stem(name) + ".npz")

    @staticmethod
    def _sidecar(npz_path: str) -> str:
        """The `.name` sidecar path for a checkpoint path — ONE site owns
        the npz/sidecar naming pairing (warm restart breaks silently if a
        writer and the recovery scan ever disagree)."""
        return npz_path[: -len(".npz")] + ".name"

    def _recover_spills(self) -> None:
        """Seed the spilled-name set from an existing spill directory (a
        prior run's checkpoints). Only a `.name` sidecar whose content
        re-hashes to its own stem AND has a checkpoint next to it is
        trusted — foreign files, tmp leftovers, and truncated sidecars are
        skipped."""
        d = self._spill_dir
        if not os.path.isdir(d):
            return
        for fn in os.listdir(d):
            if not (fn.endswith(".name") and len(fn) == 45):
                continue
            try:
                with open(os.path.join(d, fn), encoding="utf-8") as fh:
                    name = fh.read()
            except (OSError, UnicodeDecodeError):
                # Unreadable OR non-UTF-8 (foreign file, sidecar truncated
                # mid multi-byte char): skip it — one bad file must never
                # prevent the server from booting.
                continue
            stem = fn[: -len(".name")]
            if (self._stem(name) == stem
                    and os.path.exists(os.path.join(d, stem + ".npz"))):
                self._spilled.add(name)

    @staticmethod
    def _account(f) -> int:
        """Host+device bytes a stored filter pins (TrainedFilter /
        FactoredFilter nbytes; 0 for objects without accounting)."""
        fn = getattr(getattr(f, "trained", None), "nbytes", None)
        try:
            return int(fn()) if callable(fn) else 0
        except Exception:
            return 0

    def _resident_bytes_locked(self) -> int:
        return sum(self._bytes.values())

    def _pick_victims_locked(self) -> list:
        """Pop LRU filters past capacity — by COUNT (max_filters) or by
        BYTES (max_bytes) — mark them spilled and (when the checkpoint is
        stale) queue them for an out-of-lock save. The newest filter is
        never evicted even when it alone exceeds the byte budget (it must
        stay servable; the budget then holds as soon as it has company)."""
        victims = []
        while len(self._resident) > 1 and (
                len(self._resident) > self.max_filters
                or self._resident_bytes_locked() > self.max_bytes):
            name, f = self._resident.popitem(last=False)
            self._bytes.pop(name, None)
            self.evictions += 1
            if name not in self._on_disk:
                self._saving[name] = f
                victims.append((name, f))
            self._spilled.add(name)
        return victims

    def _write_checkpoint(self, name: str, f) -> None:
        # Write-to-temp + atomic rename: a concurrent get() may be
        # np.load-ing this very path (reloads run outside every lock);
        # overwriting in place would hand it a truncated npz (EOFError
        # mid-request — found by tests' concurrent stress hammer).
        # os.replace keeps every reader on a complete file: the old
        # inode until the rename, the new one after.
        path = self._path(name)
        tmp = path + f".tmp-{threading.get_ident()}.npz"
        try:
            f.trained.save(tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        # Name sidecar for warm restart (_recover_spills). Written
        # AFTER the checkpoint: a sidecar without its .npz is ignored
        # on recovery, the reverse would advertise a missing filter.
        side = self._sidecar(path)
        if not os.path.exists(side):  # content is hash-determined
            stmp = side + f".tmp-{threading.get_ident()}"
            with open(stmp, "w", encoding="utf-8") as fh:
                fh.write(name)
            os.replace(stmp, side)

    def _save_victims(self, victims: list) -> None:
        """Write evicted filters' checkpoints. Runs WITHOUT the store lock
        (a save fetches and compresses the (N, k) eigvecs — seconds; holding
        the store lock would stall every concurrent request) and WITH the
        device lock (the fetch is device traffic).

        Every step is identity-guarded against a concurrent re-train of the
        same name (put() invalidates the pending save by popping _saving):
        skipping both the save and the _on_disk mark when the victim object
        is no longer the name's authoritative filter — otherwise a slow save
        could mark a NEWER filter as checkpointed while the disk holds the
        OLD one, and a later clean eviction would silently serve stale
        edits. Save failures (disk full, ...) must not escape into the
        unrelated request thread that happened to trigger the eviction: the
        victim is reinstated as resident (temporary capacity overflow, with
        a warning) rather than lost."""
        from nle_tpu_torch.utils.logging import logger

        def pending(name, f) -> bool:
            with self._lock:
                return self._saving.get(name) is f

        write_atomic = self._write_checkpoint

        for name, f in victims:
            if not pending(name, f):
                continue  # re-trained while queued: save is moot
            try:
                if self._device_lock is not None:
                    with self._device_lock:
                        # Re-check INSIDE the device lock: while this thread
                        # waited, a re-train + re-eviction may have queued
                        # and COMPLETED a save of the newer filter (the
                        # device lock is not FIFO); writing now would
                        # overwrite that fresh checkpoint with the stale
                        # filter while _on_disk still marks it valid. With
                        # the lock held no other saver can interleave after
                        # this check.
                        if not pending(name, f):
                            continue
                        write_atomic(name, f)
                else:
                    if not pending(name, f):
                        continue
                    write_atomic(name, f)
            except Exception as e:
                with self._lock:
                    if self._saving.get(name) is f:
                        self._saving.pop(name)
                        if name not in self._resident:
                            # Keep the filter alive (over capacity) instead
                            # of losing it to a failed checkpoint write.
                            self._resident[name] = f
                            self._bytes[name] = self._account(f)
                            self._resident.move_to_end(name)
                            self._spilled.discard(name)
                logger.warning(
                    "filter spill save failed for %r (kept resident): %s",
                    name, e)
                continue
            with self._lock:
                if self._saving.get(name) is f:
                    self._saving.pop(name)
                    self._on_disk.add(name)

    def put(self, name: str, f) -> None:
        nb = self._account(f)   # outside the lock: touches device metadata
        with self._lock:
            self._resident[name] = f
            self._bytes[name] = nb
            self._resident.move_to_end(name)
            self._gen[name] = self._gen.get(name, 0) + 1
            self._spilled.discard(name)
            self._on_disk.discard(name)   # a fresh training invalidates it
            self._saving.pop(name, None)  # ... and any pending spill save
            victims = self._pick_victims_locked()
        self._save_victims(victims)

    def get(self, name: str):
        """Resident hit, in-flight-eviction hit, spilled reload, or
        KeyError."""
        from nle_tpu_torch.models import filter as filter_mod

        while True:
            with self._lock:
                f = self._resident.get(name)
                if f is not None:
                    self._resident.move_to_end(name)
                    return f
                f = self._saving.get(name)
                if f is not None:
                    # Evicted, checkpoint still being written: serve the
                    # live object (it stays spilled; no recency
                    # reinstatement).
                    return f
                if name not in self._spilled:
                    raise KeyError(
                        f"no trained filter named {name!r} "
                        f"(have: {self._names_locked()})")
                gen = self._gen.get(name, 0)
            # Disk decompress OUTSIDE both locks: a cold reload must not
            # block unrelated requests' store lookups, and the seconds of
            # zlib for a megapixel filter are pure host CPU — only the
            # device UPLOAD takes the device lock (it is device traffic
            # like the spill saves, and an unguarded ~N*k upload concurrent
            # with a card-sized training can run the card out of memory).
            try:
                arrays = filter_mod.load_filter_host(self._path(name))
            except FileNotFoundError:
                # A concurrent DELETE unlinked the checkpoint between the
                # spilled-check and np.load. That is a caller-visible
                # unknown-name condition (400), not a server fault (500):
                # retry — the next iteration observes the deletion (gen
                # bumped, name no longer spilled) and raises KeyError.
                continue
            lock = (self._device_lock if self._device_lock is not None
                    else contextlib.nullcontext())
            with lock:
                loaded = filter_mod.NLEFilter(
                    trained=filter_mod.filter_from_host(arrays, self.device),
                    device=self.device)
            with self._lock:
                cur = self._resident.get(name)
                if cur is not None:  # lost a reload race — use the winner
                    self._resident.move_to_end(name)
                    return cur
                f = self._saving.get(name)
                if f is not None:  # re-trained + mid-eviction while loading
                    return f
                if self._gen.get(name, 0) != gen:
                    # Re-trained (and already evicted again) while this
                    # thread was np.load-ing: the bytes just read may be
                    # the PRE-re-train checkpoint — installing them would
                    # silently serve stale edits. Retry against the fresh
                    # state.
                    continue
                self._spilled.discard(name)
                # The checkpoint on disk stays valid for this reloaded copy.
                self._on_disk.add(name)
                self._resident[name] = loaded
                self._bytes[name] = self._account(loaded)
                victims = self._pick_victims_locked()
            self._save_victims(victims)
            return loaded

    def delete(self, name: str) -> None:
        """Remove a kept filter: resident object, pending spill save,
        spilled checkpoint, and sidecar. Raises KeyError for an unknown
        name. The generation bump makes any in-flight cold reload of the
        same name retry and observe the deletion instead of re-installing
        the just-unlinked checkpoint's bytes."""
        with self._lock:
            known = (name in self._resident or name in self._saving
                     or name in self._spilled)
            if not known:
                raise KeyError(
                    f"no trained filter named {name!r} "
                    f"(have: {self._names_locked()})")
            self._resident.pop(name, None)
            self._bytes.pop(name, None)
            self._saving.pop(name, None)   # invalidates a pending save
            self._spilled.discard(name)
            self._on_disk.discard(name)
            self._gen[name] = gen = self._gen.get(name, 0) + 1
        if self._spill_dir is None:
            # Nothing can be on disk, and _path() would lazily mkdtemp a
            # spill dir as a side effect — which also flips the shutdown
            # sweep from instant exit to a checkpoint pass. Skip entirely.
            return
        path = self._path(name)
        # Unlink INSIDE the device lock: every checkpoint writer
        # (_save_victims, checkpoint_all) writes while holding it and
        # re-checks its claim-to-authority after acquiring it, so a saver
        # already past its check finishes BEFORE we unlink, and one not yet
        # there observes the popped _saving entry and skips — without this,
        # a mid-write saver re-creates the files after the unlink and the
        # deleted filter resurrects on warm restart.
        lock = (self._device_lock if self._device_lock is not None
                else contextlib.nullcontext())
        with lock:
            with self._lock:
                # The device lock is not FIFO: while this delete waited, a
                # /train of the SAME name (plus an eviction) may have slipped
                # in and written the NEW filter's checkpoint. Unlinking now
                # would permanently lose the re-trained filter (its state
                # says spilled/on-disk but the file is gone). Any sign of
                # re-creation — a gen bump past ours or live store state —
                # means the files now belong to the newer filter: leave them.
                recreated = (self._gen.get(name, 0) != gen
                             or name in self._resident
                             or name in self._saving
                             or name in self._spilled)
            if recreated:
                return
            for p in (path, self._sidecar(path)):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass

    def checkpoint_all(self) -> int:
        """Write every live filter's checkpoint (+ name sidecar) so a
        restart on the same spill_dir recovers the FULL namespace, not just
        what the LRU happened to evict — the graceful-shutdown half of warm
        restart. Covers resident filters AND evictees whose background
        spill save is still in flight (_saving — daemon threads die with
        the process, so a mid-fetch save would otherwise be lost). Filters
        whose on-disk checkpoint is already current are skipped. Returns
        the number written. On the card each save's fetch waits for the
        work queued before it (the filter's own training included)."""
        from nle_tpu_torch.utils.logging import logger

        with self._lock:
            items = [(n, f) for n, f in self._resident.items()
                     if n not in self._on_disk]
            items += [(n, f) for n, f in self._saving.items()
                      if n not in self._on_disk and n not in self._resident]
        written = 0
        for name, f in items:
            def current() -> bool:
                with self._lock:
                    return (self._resident.get(name) is f
                            or self._saving.get(name) is f)
            try:
                if self._device_lock is not None:
                    with self._device_lock:  # the save fetches device bufs
                        if not current():
                            continue  # re-trained while we waited
                        self._write_checkpoint(name, f)
                else:
                    if not current():
                        continue
                    self._write_checkpoint(name, f)
            except Exception as e:
                logger.warning("checkpoint_all: save failed for %r: %s",
                               name, e)
                continue
            with self._lock:
                if self._resident.get(name) is f:
                    self._on_disk.add(name)
            written += 1
        return written

    def _names_locked(self) -> list:
        return sorted(set(self._resident) | self._spilled)

    def names(self) -> list:
        # Snapshot under the store lock: iterating the live dict/set while
        # put()/spill threads mutate them raises "changed size during
        # iteration". get()'s error path (which already holds the
        # non-reentrant lock) uses _names_locked directly.
        with self._lock:
            return self._names_locked()

    def stats(self) -> dict:
        with self._lock:
            return {"resident": len(self._resident),
                    "spilled": len(self._spilled),
                    "resident_bytes": self._resident_bytes_locked(),
                    "max_bytes": self.max_bytes,
                    "evictions": self.evictions}


class _Metrics:
    """Per-endpoint request counters and wall-clock, plus train/edit
    totals (the observability VERDICT of a serving subsystem: how many
    filters were built, how many edits served, how slow)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.endpoints: dict[str, dict] = {}
        self.trains = 0          # filters built (one per request even when
        self.edits = 0           # coalesced — each request gets its own)
        self.train_batches = 0   # device training dispatches (coalesced
        self.batched_filters = 0 # groups count once; this sums their sizes)
        self.errors = 0
        self.rejected = 0        # auth / size-limit refusals

    def count_batch(self, n_filters: int):
        """One pipelined training dispatch covering n_filters filters."""
        with self._lock:
            self.train_batches += 1
            self.batched_filters += n_filters

    # Per-endpoint latency reservoir: the last _LAT_WINDOW samples (ring
    # buffer) back the P50/P99 quantiles in the snapshot — a sliding
    # window, not lifetime, so the quantiles track CURRENT behavior
    # (a warm server is not forever haunted by its first-request P99).
    _LAT_WINDOW = 1024

    def record(self, endpoint: str, seconds: float, ok: bool,
               trains: int = 0, edits: int = 0):
        with self._lock:
            e = self.endpoints.setdefault(
                endpoint, {"count": 0, "errors": 0, "total_sec": 0.0,
                           "last_sec": 0.0, "_lat": []})
            e["count"] += 1
            e["total_sec"] += seconds
            e["last_sec"] = seconds
            lat = e["_lat"]
            if len(lat) < self._LAT_WINDOW:
                lat.append(seconds)
            else:
                lat[e["count"] % self._LAT_WINDOW] = seconds
            if not ok:
                e["errors"] += 1
                self.errors += 1
            self.trains += trains
            self.edits += edits

    def reject(self):
        with self._lock:
            self.rejected += 1

    @staticmethod
    def _quantile(sorted_lat: list, q: float) -> float:
        # Nearest-rank on the sorted window (no interpolation: with a few
        # samples P99 = the worst observed, which is the honest answer).
        i = min(len(sorted_lat) - 1, int(q * len(sorted_lat)))
        return sorted_lat[i]

    def snapshot(self) -> dict:
        with self._lock:
            eps = {}
            for k, v in self.endpoints.items():
                lat = sorted(v["_lat"])
                eps[k] = {
                    **{kk: vv for kk, vv in v.items() if kk != "_lat"},
                    "total_sec": round(v["total_sec"], 3),
                    "last_sec": round(v["last_sec"], 3),
                    "mean_sec": round(v["total_sec"] / max(1, v["count"]), 3),
                    "p50_sec": round(self._quantile(lat, 0.50), 3),
                    "p99_sec": round(self._quantile(lat, 0.99), 3),
                }
            return {"trains": self.trains, "edits": self.edits,
                    "train_batches": self.train_batches,
                    "batched_filters": self.batched_filters,
                    "errors": self.errors, "rejected": self.rejected,
                    "endpoints": eps}


class _Service:
    """One device, many requests: filters by name + a device lock; one-shot
    enhance trainings coalesce into pipelined batches. `device` is "cuda"
    (the default; raises without a card) or "cpu"."""

    def __init__(self, max_filters: int = DEFAULT_MAX_FILTERS,
                 spill_dir: str | None = None,
                 max_filter_bytes: int = DEFAULT_MAX_FILTER_BYTES,
                 reuse_delta: float | None = None, *, device="cuda"):
        from nle_tpu_torch.config import resolve_device

        self.device = resolve_device(device)
        self.lock = threading.Lock()
        self.store = _FilterStore(max_filters, spill_dir,
                                  device_lock=self.lock,
                                  max_bytes=max_filter_bytes,
                                  device=self.device)
        self.metrics = _Metrics()
        self.trainer = _CoalescingTrainer(self.lock, self.metrics,
                                          reuse_delta=reuse_delta,
                                          device=self.device)

    @staticmethod
    def _params(q):
        return (int(q["nr"][0]), int(q["nc"][0]), float(q["hx"][0]),
                float(q["hy"][0]), int(q.get("iters", ["10"])[0]),
                int(q.get("k", ["5"])[0]))

    @staticmethod
    def _factored(q) -> bool:
        return q.get("factored", ["0"])[0].lower() in ("1", "true", "yes")

    @staticmethod
    def _too_big_to_pipeline(img, params, device="cuda") -> bool:
        """The coalescing trainer keeps dense (npad, mpad) phi buffers of
        the frames in flight alive (models/batch.py lookahead) — past that
        ceiling, route to the per-request train_filter (which auto-streams)
        instead of the coalescer. The capacity rule itself is shared with
        the trainer (models/batch.py fits_pipeline, which reads the card's
        free memory, resident filters included), which also self-guards."""
        from nle_tpu_torch.models.batch import fits_pipeline

        n = int(img.shape[0]) * int(img.shape[1])
        return not fits_pipeline(n, int(params[0]), int(params[1]),
                                 device=device)

    def _make_filter(self, img, q, denoise: bool):
        from nle_tpu_torch.models.filter import NLEFilter

        # factored=1: V-free capacity mode — kept filters cost ~17 B/pixel
        # instead of 4k B/pixel (models/factored.py).
        f = NLEFilter(device=self.device, factored=self._factored(q))
        args = (img,) + self._params(q)
        if denoise:
            f.train_for_denoise(
                *args, sigma_color=float(q.get("sigma_color", ["10"])[0]),
                sigma_space=float(q.get("sigma_space", ["10"])[0]))
        else:
            f.train_for_enhancement(*args)
        self.metrics.count_batch(1)
        return f

    def enhance(self, body, q):
        from nle_tpu_torch.models.filter import NLEFilter

        # Cheap validation FIRST (params + weight parse): a malformed
        # request must not cost a full image decode on the request thread
        # (same rule apply() documents).
        params = self._params(q)
        w = [float(x) for x in q.get("w", ["2,3,4,1"])[0].split(",")]
        img = _decode_bgr(body)
        if self._factored(q) or self._too_big_to_pipeline(
                img, params, device=self.device):
            # V-free capacity mode, or an image past the pipelined
            # trainer's dense ceiling: the per-request path's train_filter
            # auto-selects the phi-free streaming stage 2 (the coalescing
            # trainer is dense-only and would run out of memory).
            with self.lock:
                f = self._make_filter(img, q, denoise=False)
                out = f.enhance(img, w)
        else:
            # Coalescing path: blocks until the worker trained our filter —
            # concurrent same-shape/params requests share one pipelined
            # batch. The edit deliberately does NOT take the device lock:
            # the worker still holds it while training the REST of the
            # batch, and this request's apply queues on the same default
            # stream between those trainings (the stream orders it after
            # its own filter's stage 2b). Memory-safe: on top of a V that is
            # resident either way, the apply adds a few bytes a pixel: the
            # u8 channel in and out, the gather's and scatter's u8 buffers
            # and the filter's int32 index of perm (4 B/pixel, built at its
            # first edit and counted by its nbytes from the start).
            flt, lab = self.trainer.train_enhancement(img, params)
            f = NLEFilter(trained=flt, device=self.device)
            # Reuse the trainer's BGR->Lab conversion: converting again per
            # edit would double the host's Lab work on the serving path.
            f.seed_lab_cache(img, lab)
            out = f.enhance(img, w)
        # PNG encode is pure host CPU — never under the device lock.
        return _encode_png(out)

    def denoise(self, body, q):
        # Params before decode (cheap-validation-first, as in apply()).
        self._params(q)
        shrink = float(q.get("shrink", ["2"])[0])
        sigma_color = float(q.get("sigma_color", ["10"])[0])
        sigma_space = float(q.get("sigma_space", ["10"])[0])
        img = _decode_bgr(body)
        with self.lock:
            f = self._make_filter(img, q, denoise=True)
            out = f.denoise(img, shrink, sigma_color=sigma_color,
                            sigma_space=sigma_space)
        return _encode_png(out)

    def train(self, body, q):
        # Params before decode (cheap-validation-first, as in apply()).
        self._params(q)
        name = q.get("name", ["default"])[0]
        # mode=denoise trains on the bilateral-prefiltered L channel (the
        # reference's trainForDenoise, src/filter.cpp:521-537) so a kept
        # filter used with /apply?op=denoise reproduces the one-shot
        # /denoise result; the default trains on raw L (trainForEnhancement).
        mode = q.get("mode", ["enhance"])[0]
        if mode not in ("enhance", "denoise"):
            raise ValueError(f"unknown mode {mode!r} (enhance|denoise)")
        img = _decode_bgr(body)
        with self.lock:
            f = self._make_filter(img, q, denoise=(mode == "denoise"))
        self.store.put(name, f)
        t = f.trained
        k = int(t.eigvals.shape[0])
        return json.dumps({
            "name": name, "k": k, "mode": mode,
            "shape": [int(t.nrows), int(t.ncols)],
        }).encode()

    def apply(self, body, q):
        # Cheap validation FIRST (name lookup, op, weight parse): a bad
        # request must not cost a full image decode on the request thread.
        name = q.get("name", ["default"])[0]
        op = q.get("op", ["enhance"])[0]
        if op not in ("enhance", "denoise"):
            raise ValueError(f"unknown op {op!r} (enhance|denoise)")
        w = [float(x) for x in q.get("w", ["2,3,4,1"])[0].split(",")]
        f = self.store.get(name)
        img = _decode_bgr(body)
        if op == "denoise":
            # GLIDE application of a kept filter: shrink + chroma-only
            # spectral filtering (models/filter.py denoise).
            with self.lock:
                out = f.denoise(
                    img, float(q.get("shrink", ["2"])[0]),
                    sigma_color=float(q.get("sigma_color", ["10"])[0]),
                    sigma_space=float(q.get("sigma_space", ["10"])[0]))
        else:
            with self.lock:
                out = f.enhance(img, w)
        return _encode_png(out)


def _device_memory(device) -> dict:
    """Actual device memory per visible card, under the JAX package's keys:
    bytes_in_use and peak_bytes_in_use from torch's caching allocator
    (tensors this process holds, resident filters included) and
    bytes_limit, the card's total memory. The store's resident_bytes
    accounts MODEL bytes only; this also shows transient training buffers.
    On the CPU it is {} — absence of data, not zero."""
    import torch

    if torch.device(device).type != "cuda":
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[str(i)] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
        }
    return out


def make_server(port: int = 0, token: str | None = None,
                max_bytes: int = DEFAULT_MAX_BYTES,
                max_filters: int = DEFAULT_MAX_FILTERS,
                spill_dir: str | None = None,
                access_log=None,
                max_filter_bytes: int = DEFAULT_MAX_FILTER_BYTES,
                reuse_delta: float | None = None,
                device="cuda",
                ) -> ThreadingHTTPServer:
    """access_log: None (off), or a write()-able stream that receives one
    JSON line per request: ts, client, method, path, status, ms, bytes_in,
    bytes_out (structured access logging for the serving subsystem).
    reuse_delta: opt-in temporal warm-start for coalesced one-shot
    /enhance bursts (see _CoalescingTrainer). device: "cuda" (the default;
    raises without a card) or "cpu"."""
    svc = _Service(max_filters=max_filters, spill_dir=spill_dir,
                   max_filter_bytes=max_filter_bytes,
                   reuse_delta=reuse_delta, device=device)
    token = token if token is not None else os.environ.get("NLE_SERVE_TOKEN")
    log_lock = threading.Lock()
    device_name = None
    if svc.device.type == "cuda":
        import torch

        device_name = torch.cuda.get_device_name(svc.device)

    def access(handler, status: int, ms: float, n_in: int, n_out: int):
        if access_log is None:
            return
        line = json.dumps({
            "ts": round(time.time(), 3),
            "client": handler.client_address[0],
            "method": handler.command,
            "path": handler.path,
            "status": status, "ms": round(ms, 1),
            "bytes_in": n_in, "bytes_out": n_out,
        })
        with log_lock:
            access_log.write(line + "\n")
            access_log.flush()

    # Which endpoints count as train vs edit in /metrics.
    TRAINS = {"/enhance": 1, "/denoise": 1, "/train": 1, "/apply": 0}
    EDITS = {"/enhance": 1, "/denoise": 1, "/train": 0, "/apply": 1}

    class Handler(BaseHTTPRequestHandler):
        # Socket read timeout (StreamRequestHandler.setup applies it to the
        # connection): without one, a client that stalls mid-body — or just
        # holds idle keep-alive connections — pins a server thread forever
        # (slowloris), unauthenticated, since reads happen before any auth
        # check. ThreadingHTTPServer has no thread bound, so the leak is
        # unbounded. Timed-out reads surface as socket.timeout, which
        # handle_one_request maps to close_connection. 0 (or empty) means
        # NO timeout — it must map to None, not settimeout(0), which is
        # non-blocking mode and would fail every read.
        _t = int(os.environ.get("NLE_SERVE_SOCKET_TIMEOUT", "120") or 0)
        timeout = _t if _t > 0 else None

        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code, body, ctype, ms: float = 0.0,
                   n_in: int = 0):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            # Logged before the body goes out: a client that has read its
            # response finds the request's line in the log.
            access(self, code, ms, n_in, len(body))
            self.wfile.write(body)

        def _json_err(self, code, msg, ms: float = 0.0, n_in: int = 0):
            return self._reply(code, json.dumps({"error": msg}).encode(),
                               "application/json", ms=ms, n_in=n_in)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                # Answers without touching a kernel: the kernels build at
                # the first request that runs them, not before.
                body = json.dumps({
                    "ok": True, "platform": svc.device.type,
                    **({"device_name": device_name}
                       if device_name is not None else {}),
                    "filters": svc.store.names(),
                }).encode()
                return self._reply(200, body, "application/json")
            if path == "/metrics":
                body = json.dumps({**svc.metrics.snapshot(),
                                   "filters": svc.store.stats(),
                                   "device_memory": _device_memory(
                                       svc.device)},
                                  ).encode()
                return self._reply(200, body, "application/json")
            return self._json_err(404, "not found")

        def do_DELETE(self):
            u = urlparse(self.path)
            # DELETE bodies are never used, but a client MAY send one: the
            # bytes must be consumed (or the connection closed) or the next
            # request parse on this keep-alive connection desyncs — body
            # bytes get interpreted as a request line.
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = -1
            if n < 0:
                svc.metrics.reject()
                self.close_connection = True
                return self._json_err(400, "bad Content-Length header")
            if not self._check_auth(n):
                return
            if n:
                self._drain_body(n)  # bounded; closes past the cap
            if u.path != "/filters":
                return self._json_err(404, "not found")
            name = parse_qs(u.query).get("name", ["default"])[0]
            t0 = time.perf_counter()
            try:
                svc.store.delete(name)
            except KeyError as e:
                svc.metrics.record(u.path, time.perf_counter() - t0, False)
                return self._json_err(404, str(e))
            except Exception as e:  # half-deleted state (disk fault, ...)
                # must surface as a 500, not a dropped connection
                svc.metrics.record(u.path, time.perf_counter() - t0, False)
                return self._json_err(500, f"{type(e).__name__}: {e}")
            svc.metrics.record(u.path, time.perf_counter() - t0, True)
            return self._reply(200, json.dumps({"deleted": name}).encode(),
                               "application/json")

        def _check_auth(self, n: int) -> bool:
            """Bearer-token gate for the mutating methods. Returns False
            (response already sent) on failure."""
            if not token:
                return True
            import hmac

            auth = self.headers.get("Authorization", "")
            # Constant-time compare: != short-circuits at the first
            # differing byte, leaking the token prefix to a client
            # that can time responses (this is the only auth gate).
            if hmac.compare_digest(auth, f"Bearer {token}"):
                return True
            svc.metrics.reject()
            self._drain_body(n)
            self._json_err(401, "missing or bad bearer token")
            return False

        def _drain_body(self, n: int):
            """Read and discard up to n bytes (bounded, chunked — never
            buffered) so a mid-upload client finishes sending and reliably
            sees the error status instead of a broken pipe; give up past
            a fixed cap and just close. The cap is deliberately SMALL
            (8 MiB, not a multiple of max_bytes): rejected requests —
            including unauthenticated ones — must not be able to make the
            server read hundreds of MB from the socket per connection."""
            remaining = min(n, _DRAIN_CAP)
            while remaining > 0:
                chunk = self.rfile.read(min(remaining, 1 << 16))
                if not chunk:
                    break
                remaining -= len(chunk)
            self.close_connection = True

        def do_POST(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = -1
            if n < 0:
                # Non-numeric or negative Content-Length: never pass it to
                # rfile.read (read(-1) blocks until client EOF, hanging the
                # handler thread on a keep-alive connection).
                svc.metrics.reject()
                self.close_connection = True
                return self._json_err(400, "bad Content-Length header")
            if not self._check_auth(n):
                return
            if n > max_bytes:
                svc.metrics.reject()
                self._drain_body(n)
                return self._json_err(
                    413, f"request body {n} bytes exceeds limit {max_bytes}")
            body = self.rfile.read(n)
            route = {"/enhance": svc.enhance, "/denoise": svc.denoise,
                     "/train": svc.train, "/apply": svc.apply}.get(u.path)
            if route is None:
                return self._json_err(404, "not found")
            t0 = time.perf_counter()
            try:
                out = route(body, q)
            except (ValueError, KeyError, IndexError) as e:
                # input-validation class: bad image bytes, bad params,
                # unknown filter name
                dt = time.perf_counter() - t0
                svc.metrics.record(u.path, dt, False)
                return self._json_err(400, f"{type(e).__name__}: {e}",
                                      ms=dt * 1e3, n_in=n)
            except Exception as e:  # server-side fault (device, kernel...)
                from nle_tpu_torch.utils.logging import logger

                logger.exception("%s %s failed", self.command, u.path)
                dt = time.perf_counter() - t0
                svc.metrics.record(u.path, dt, False)
                return self._json_err(500, f"{type(e).__name__}: {e}",
                                      ms=dt * 1e3, n_in=n)
            dt = time.perf_counter() - t0
            svc.metrics.record(u.path, dt, True,
                               trains=TRAINS[u.path], edits=EDITS[u.path])
            ctype = ("application/json" if out[:1] == b"{" else "image/png")
            return self._reply(200, out, ctype, ms=dt * 1e3, n_in=n)

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    srv.svc = svc  # graceful shutdown (main) checkpoints through this
    return srv


def parse_warmup_spec(spec: str) -> tuple:
    """Parse one --warmup=H,W,nr,nc[,iters[,k]] spec (iters defaults to
    10, k to 5 — the /enhance query defaults). These six integers fix the
    shapes a request's device work runs at: H*W fixes N, (nr, nc) fix p
    and the sampled grid, iters the Sinkhorn loop and k the eigenvectors;
    hx/hy/weights are operands and need no warming."""
    parts = spec.split(",")
    if not 4 <= len(parts) <= 6:
        raise ValueError(
            f"--warmup={spec!r}: expected H,W,nr,nc[,iters[,k]]")
    try:
        vals = [int(x) for x in parts]
    except ValueError:
        raise ValueError(
            f"--warmup={spec!r}: expected comma-separated integers"
        ) from None
    if any(v <= 0 for v in vals):
        raise ValueError(f"--warmup={spec!r}: values must be positive")
    h, w, nr, nc = vals[:4]
    iters = vals[4] if len(vals) > 4 else 10
    k = vals[5] if len(vals) > 5 else 5
    return (h, w, nr, nc, iters, k)


def run_warmup(specs, device="cuda") -> list:
    """Drive the serving /enhance flow once for each (H, W, nr, nc, iters,
    k) spec BEFORE the server takes traffic: the coalescing trainer
    (models/batch.py) plus the u8 edit apply, on a full-rank noise frame.
    On the card that builds the kernel library at its first use (nvcc,
    seconds; ops/kernels/_build.py) and fills torch's caching allocator
    with the spec's buffers, so the first real request of that shape pays
    neither. Returns per-spec seconds (logged by main)."""
    from nle_tpu_torch.models.filter import NLEFilter

    times = []
    for (h, w, nr, nc, iters, k) in specs:
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        t0 = time.perf_counter()
        lock = threading.Lock()
        # A throwaway trainer is safe: its drain worker exits when the
        # queue empties, and the built library and allocator cache are
        # process-wide.
        trainer = _CoalescingTrainer(lock, None, device=device)
        flt, lab = trainer.train_enhancement(
            img, (nr, nc, 500.0, 10.0, iters, k))
        f = NLEFilter(trained=flt, device=device)
        f.seed_lab_cache(img, lab)
        out = f.enhance(img, [2.0, 3.0, 4.0, 1.0])
        assert out.shape == img.shape
        times.append(time.perf_counter() - t0)
    return times


def selftest(device="cuda") -> float:
    """Start the server on an ephemeral port, run the flower golden config
    through real HTTP round trips (train-once + edit-many included), return
    the PSNR vs the reference golden output (the reference's data
    directory, REFERENCE_DATA; without it the selftest fails)."""
    import urllib.request

    srv = make_server(device=device)
    port = srv.server_address[1]
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            assert json.loads(r.read())["ok"]
        data = open(os.path.join(REFERENCE_DATA, "flower-50.bmp"),
                    "rb").read()
        cfg = "nr=10&nc=20&hx=100&hy=30&iters=50&k=30&w=2,3,4,1"
        req = urllib.request.Request(f"{base}/enhance?{cfg}", data=data)
        with urllib.request.urlopen(req, timeout=600) as r:
            out = _decode_bgr(r.read())
        # train-once / edit-many round trip
        req = urllib.request.Request(
            f"{base}/train?name=flower&{cfg}", data=data)
        with urllib.request.urlopen(req, timeout=600) as r:
            meta = json.loads(r.read())
        assert meta["k"] == 30, meta
        req = urllib.request.Request(
            f"{base}/apply?name=flower&w=2,3,4,1", data=data)
        with urllib.request.urlopen(req, timeout=600) as r:
            out2 = _decode_bgr(r.read())
        assert np.array_equal(out, out2), "apply != one-shot enhance"
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            m = json.loads(r.read())
        assert m["trains"] >= 2 and m["edits"] >= 2, m
        golden = _decode_bgr(open(os.path.join(
            REFERENCE_DATA, "flower-filtered.png"), "rb").read())
        mse = np.mean((out.astype(np.float64) - golden.astype(np.float64)) ** 2)
        psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        return float(psnr)
    finally:
        srv.shutdown()


USAGE = ("usage: python -m nle_tpu_torch.serving.http [--port=N] "
         "[--token=SECRET] [--max-bytes=N] [--max-filters=N] "
         "[--max-filter-bytes=N] [--spill-dir=DIR] "
         "[--warmup=H,W,nr,nc[,iters[,k]] ...] [--access-log=PATH|-] "
         "[--device=cuda|cpu] [--reuse-delta=D] [--selftest]\n"
         "  --reuse-delta=D: a coalesced /enhance batch trains a frame whose "
         "mean |L delta| from the batch's last trained frame is <= D once "
         "and serves the other frame that filter; a batch may hold "
         "requests of different clients, so one client's frame may be "
         "edited with a filter trained on another's")


def main():
    port = 8807
    run_selftest = False
    device = "cuda"
    token = None
    max_bytes = int(os.environ.get("NLE_SERVE_MAX_BYTES", DEFAULT_MAX_BYTES))
    max_filters = int(os.environ.get("NLE_SERVE_MAX_FILTERS",
                                     DEFAULT_MAX_FILTERS))
    max_filter_bytes = int(os.environ.get("NLE_SERVE_MAX_FILTER_BYTES",
                                          DEFAULT_MAX_FILTER_BYTES))
    spill_dir = None
    access_log_path = None
    warmup_specs = []
    reuse_delta = None
    for a in sys.argv[1:]:
        if a.startswith("--port="):
            port = int(a.split("=", 1)[1])
        elif a.startswith("--reuse-delta="):
            try:
                reuse_delta = float(a.split("=", 1)[1])
                if not reuse_delta >= 0:   # rejects NaN too
                    raise ValueError
            except ValueError:
                print(f"nle-serve: --reuse-delta needs a nonnegative "
                      f"float, got {a.split('=', 1)[1]!r}",
                      file=sys.stderr)
                sys.exit(2)
        elif a.startswith("--warmup="):
            try:
                warmup_specs.append(parse_warmup_spec(a.split("=", 1)[1]))
            except ValueError as e:
                # Same loud-usage path as an unknown flag — a typo'd spec
                # must not traceback past the argv parser.
                print(f"nle-serve: {e}\n{USAGE}", file=sys.stderr)
                sys.exit(2)
        elif a == "--selftest":
            run_selftest = True
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
            if device not in ("cuda", "cpu"):
                print(f"nle-serve: --device={device} invalid (expected "
                      f"cuda|cpu)\n{USAGE}", file=sys.stderr)
                sys.exit(2)
        elif a.startswith("--token="):
            token = a.split("=", 1)[1]
        elif a.startswith("--max-bytes="):
            max_bytes = int(a.split("=", 1)[1])
        elif a.startswith("--max-filters="):
            max_filters = int(a.split("=", 1)[1])
        elif a.startswith("--max-filter-bytes="):
            max_filter_bytes = int(a.split("=", 1)[1])
        elif a.startswith("--spill-dir="):
            spill_dir = a.split("=", 1)[1]
        elif a.startswith("--access-log="):
            access_log_path = a.split("=", 1)[1]
        else:
            # A silently-ignored typo is dangerous here: `--tokn=...` would
            # start an UNAUTHENTICATED server. Fail loudly instead.
            print(f"nle-serve: unknown argument {a!r}\n{USAGE}",
                  file=sys.stderr)
            sys.exit(2)
    if run_selftest:
        psnr = selftest(device)
        print(f"selftest PSNR: {psnr:.2f} dB")
        sys.exit(0 if psnr >= 45.0 else 1)
    # Warm BEFORE binding the port: health checks / requests only see an
    # open socket once every expected shape has run. One run_warmup call
    # per spec so progress prints as each finishes.
    for spec in warmup_specs:
        (secs,) = run_warmup([spec], device=device)
        print(f"nle-serve: warmed {spec} in {secs:.1f}s", flush=True)
    access_log = (sys.stdout if access_log_path == "-"
                  else open(access_log_path, "a")
                  if access_log_path else None)
    srv = make_server(port, token=token, max_bytes=max_bytes,
                      max_filters=max_filters, spill_dir=spill_dir,
                      access_log=access_log,
                      max_filter_bytes=max_filter_bytes,
                      reuse_delta=reuse_delta, device=device)
    print(f"nle-tpu edit service on http://127.0.0.1:{port} "
          f"({srv.svc.device.type}; POST /enhance /denoise /train /apply, "
          "GET /healthz /metrics, DELETE /filters?name=)", flush=True)
    # Graceful shutdown: SIGTERM/SIGINT checkpoint every resident filter
    # before exiting, so a restart on the same --spill-dir recovers the
    # FULL namespace (warm restart), not just what the LRU had evicted.
    import signal

    def _sigterm(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # The first signal means "shut down"; a late SECOND TERM/INT (e.g.
        # a supervisor re-signaling, or `timeout` forwarding) must not
        # abort the checkpoint sweep mid-npz-write.
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        # Sweep only when checkpoints have somewhere durable to live: a
        # configured --spill-dir, or the lazily-made temp dir that already
        # holds this run's evictions (the printed path lets the operator
        # restart with --spill-dir=<it>). With neither, shutdown must stay
        # instant — each megapixel checkpoint is seconds of fetch and
        # compression.
        if srv.svc.store._spill_dir is not None:
            n = srv.svc.store.checkpoint_all()
            if n:
                print(f"nle-serve: checkpointed {n} filter(s) to "
                      f"{srv.svc.store._spill_dir}", file=sys.stderr)


if __name__ == "__main__":
    main()
