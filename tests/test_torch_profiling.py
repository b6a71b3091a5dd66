"""The port's tracer (``mmgclip_tpu_torch/utils/profiling.py``) and the spans
of the feature-store encode, on the CPU.

* Recording follows the profiler: ``tracing()`` is on only while a
  ``torch.profiler`` session is active on the calling thread (off in a pool
  worker of that thread), and an untraced encode records nothing.
* Records carry their parent: nested main-thread spans and a worker's
  finished spans under the span that handed it the work.
* The shared clock: a main-thread span's start moved onto the profiler's
  clock lies within ``CLOCK_TOL_NS`` of its ``mmg:`` event's start (the
  median of several spans, so that a preempted thread does not decide).
* The buffer keeps the newest ``capacity`` records.
* ``maybe_trace`` writes the session's spans beside its Chrome trace.
* ``recorder()`` is ``TRACER`` only while recording; ``INERT`` takes the
  same calls, records nothing and calls no callable attribute, which
  ``TRACER`` calls as it records; a mark off the card is None and records
  no interval; ``collect`` hands items to the thread's latest
  ``collecting()`` list.
* ``_Encoder.encode_batches`` under a CPU profiler session: one
  ``encode.pass``, a decode and a decode wait per image, assemble, submit,
  read-back and write per batch with ids 0..k-1, every child inside the
  pass, no device span off the card, and the features bit-equal to an
  untraced call, which stats no file.
"""

import contextlib
import json
import os
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from mmgclip_tpu_torch.config import Config, compose
from mmgclip_tpu_torch.ingest.encode import _Encoder
from mmgclip_tpu_torch.utils import profiling
from mmgclip_tpu_torch.utils.profiling import (INERT, PREFIX, TRACER, Tracer, maybe_trace,
                                               recorder, tracing)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLOCK_TOL_NS = 100_000
CPU = [torch.profiler.ProfilerActivity.CPU]
# each encode span's attribute keys (``encode.device``, on the card only: {"batch"})
ENCODE_ATTRS = {"encode.pass": {"items", "devices", "batches"},
                "encode.decode_wait": {"item"},
                "encode.assemble": {"batch", "rows", "bytes"},
                "encode.submit": {"batch"},
                "encode.readback": {"batch"},
                "encode.write": {"batch", "rows"},
                "encode.decode": {"item", "bytes", "unfilter"}}


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_tracing_follows_the_profiler_on_this_thread():
    assert not tracing()
    with torch.profiler.profile(activities=CPU):
        assert tracing()
        with ThreadPoolExecutor(1) as pool:
            assert not pool.submit(tracing).result()
    assert not tracing()


def test_records_carry_their_parents_and_nest():
    tracer = Tracer()
    with torch.profiler.profile(activities=CPU):
        root = tracer.begin("outer", rows=3)
        child = tracer.begin("inner", root, batch=0)
        tracer.end(child)

        def work():
            t0 = time.perf_counter_ns()
            return tracer.add("worker", t0, time.perf_counter_ns(), root, item=7)

        with ThreadPoolExecutor(1) as pool:
            worker_id = pool.submit(work).result()
        tracer.end(root, bytes=12)
    records = {r["name"]: r for r in tracer.spans()}
    assert records["outer"]["parent"] is None and records["outer"]["id"] == root.id
    assert records["outer"]["attrs"] == {"rows": 3, "bytes": 12}
    assert records["inner"]["parent"] == root.id and records["inner"]["attrs"] == {"batch": 0}
    assert records["worker"]["parent"] == root.id and records["worker"]["id"] == worker_id
    assert records["worker"]["thread"] != records["outer"]["thread"] == threading.current_thread().name
    for name in ("inner", "worker"):
        assert records["outer"]["start_ns"] <= records[name]["start_ns"]
        assert records[name]["start_ns"] <= records[name]["end_ns"] <= records["outer"]["end_ns"]


def test_current_is_the_innermost_span_open_on_this_thread():
    tracer = Tracer()
    with torch.profiler.profile(activities=CPU):
        assert tracer.current() is None
        root = tracer.begin("outer")
        child = tracer.begin("inner", root)
        assert tracer.current() is child
        with ThreadPoolExecutor(1) as pool:
            assert pool.submit(tracer.current).result() is None
        tracer.end(child)
        assert tracer.current() is root
        tracer.end(root)
        assert tracer.current() is None


def test_a_span_sits_on_the_profiler_clock():
    tracer = Tracer()
    with torch.profiler.profile(activities=CPU) as prof:
        root = tracer.begin("root")  # the session's first event starts late
        for i in range(9):
            tracer.end(tracer.begin(f"step{i}", root))
        tracer.end(root)
    ours = {r["name"]: r["start_ns"] for r in tracer.to_profiler_clock(tracer.spans())}
    events = {e.name()[len(PREFIX):]: e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith(PREFIX + "step")}
    assert sorted(events) == sorted(f"step{i}" for i in range(9))
    gaps = [abs(events[name] - ours[name]) for name in events]
    assert statistics.median(gaps) <= CLOCK_TOL_NS, gaps


def test_the_buffer_drops_the_oldest_records():
    tracer = Tracer(capacity=4)
    ids = [tracer.add("s", i, i + 1) for i in range(6)]
    assert [r["id"] for r in tracer.spans()] == ids[2:]
    tracer.reset()
    assert tracer.spans() == []
    assert profiling.MAX_SPANS == TRACER._records.maxlen


def test_maybe_trace_writes_the_sessions_spans(tmp_path):
    TRACER.add("before", 0, 1)
    with maybe_trace(True, str(tmp_path)):
        TRACER.end(TRACER.begin("traced"))
    names = sorted(os.listdir(tmp_path))
    assert [n.split("_")[0] for n in names] == ["spans", "trace"]
    with open(tmp_path / names[0], encoding="utf-8") as fh:
        written = json.load(fh)
    assert [s["name"] for s in written["spans"]] == ["traced"]
    # on the profiler's clock: Unix-epoch nanoseconds
    perf_ns, epoch_ns = written["anchor"]
    record = [r for r in profiling.spans() if r["name"] == "traced"][0]
    assert written["spans"][0]["start_ns"] == record["start_ns"] - perf_ns + epoch_ns
    assert abs(written["spans"][0]["start_ns"] - time.time_ns()) < 60e9


def _refuse():
    raise AssertionError("an inert tracer called an attribute")


def test_the_recorder_is_inert_off_the_profiler():
    assert recorder() is INERT
    assert INERT.begin("s", None, 5, cost=_refuse) is None
    assert INERT.end(None, 7, cost=_refuse) is None
    assert INERT.add("s", 0, 1, None, cost=_refuse) is None
    assert INERT.mark("cpu") is None and INERT.current() is None
    assert INERT.interval("s", None, None, None, cost=_refuse) is None
    assert INERT.collecting() is None and INERT.collect(1) is None
    with torch.profiler.profile(activities=CPU):
        assert recorder() is TRACER
    assert profiling.spans() == []


def test_callable_attributes_are_computed_as_the_span_is_recorded():
    tracer = Tracer()
    calls = []
    with torch.profiler.profile(activities=CPU):
        span = tracer.begin("outer", rows=lambda: calls.append("rows") or 3)
        assert calls == []  # not before the span is recorded
        assert tracer.end(span, 99, bytes=lambda: 12) == 99
        tracer.add("worker", 0, 1, span, item=lambda: 7)
    records = {r["name"]: r for r in tracer.spans()}
    assert records["outer"]["attrs"] == {"rows": 3, "bytes": 12} and calls == ["rows"]
    assert records["outer"]["end_ns"] == 99 and records["worker"]["attrs"] == {"item": 7}


def test_a_mark_off_the_card_records_no_interval():
    tracer = Tracer()
    with torch.profiler.profile(activities=CPU):
        root = tracer.begin("root")
        begin = tracer.mark(torch.device("cpu"))
        tracer.interval("dev", begin, tracer.mark("cpu"), root, cost=_refuse)
        tracer.end(root)
    assert begin is None and [r["name"] for r in tracer.spans()] == ["root"]


def test_collect_hands_items_to_the_latest_collecting_list():
    tracer = Tracer()
    tracer.collect("dropped")  # no list yet
    first = tracer.collecting()
    tracer.collect(1)
    with ThreadPoolExecutor(1) as pool:
        pool.submit(tracer.collect, "other thread").result()
    second = tracer.collecting()
    tracer.collect(2)
    assert first == [1] and second == [2]


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    """A micro-tower CPU encoder over five small 16-bit PNGs of two shapes."""
    root = tmp_path_factory.mktemp("spans")
    items = []
    for i, (h, w) in enumerate([(40, 36)] * 3 + [(45, 38)] * 2):
        path = str(root / f"view_{i}.png")
        chip_smoke.write_png16(path, chip_smoke.synthetic_mammogram(h, w, seed=i))
        items.append((path, path))
    cfg = compose(os.path.join(REPO, "configs"), "train_binary_class_clf",
                  [f"base.features_export_dir={root / 'store'}"])
    cfg.networks.image_encoder.config = Config({"micro": True, "in_channels": 1})
    return _Encoder(cfg, batch_size=2, device="cpu"), items, str(root / "failed.txt")


def _encode(encoder):
    enc, items, failed = encoder
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's sums follow the thread count
    try:
        enc.encode_batches(items, out.__setitem__, failed)
    finally:
        torch.set_num_threads(threads)
    return out


def test_encode_records_its_spans_under_a_profiler(encoder, monkeypatch):
    def no_stat(path):
        raise AssertionError(f"an untraced encode read the size of {path}")

    with monkeypatch.context() as patched:
        patched.setattr(os.path, "getsize", no_stat)
        untraced = _encode(encoder)
    assert profiling.spans() == []
    assert set(encoder[0].timings) == {"decode_s", "decode_wait_s", "write_s"}
    with torch.profiler.profile(activities=CPU):
        traced = _encode(encoder)
    assert sorted(traced) == sorted(untraced)
    for key, vec in untraced.items():
        assert np.array_equal(traced[key], vec), key

    records = profiling.spans()
    by_name = {}
    for r in records:
        by_name.setdefault(r["name"], []).append(r)
    for name, keys in ENCODE_ATTRS.items():
        assert all(set(r["attrs"]) == keys for r in by_name[name]), name
    main = threading.current_thread().name
    assert all(r["thread"] == main for name in ENCODE_ATTRS if name != "encode.decode"
               for r in by_name[name])
    assert {r["attrs"]["unfilter"] for r in by_name["encode.decode"]} == {"host"}
    (root,) = by_name.pop("encode.pass")
    assert root["attrs"]["items"] == len(encoder[1]) and root["attrs"]["devices"] == 1
    n_items, batches = len(encoder[1]), root["attrs"]["batches"]
    assert root["parent"] is None and batches == 3  # 2 + 2 of two shapes, then the 1 left
    assert sorted(r["attrs"]["item"] for r in by_name["encode.decode"]) == list(range(n_items))
    assert sorted(r["attrs"]["item"] for r in by_name["encode.decode_wait"]) == list(range(n_items))
    assert all(r["thread"] != root["thread"] and r["attrs"]["bytes"] > 0
               for r in by_name["encode.decode"])
    for name in ("encode.assemble", "encode.submit", "encode.readback", "encode.write"):
        assert [r["attrs"]["batch"] for r in by_name[name]] == list(range(batches)), name
    assert "encode.device" not in by_name
    assert set(by_name) == {"encode.decode", "encode.decode_wait", "encode.assemble",
                            "encode.submit", "encode.readback", "encode.write"}
    for r in records:
        if r is not root:
            assert r["parent"] == root["id"], r
            assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] <= root["end_ns"], r
    # the timings take the spans' clock readings
    waits = sum(r["end_ns"] - r["start_ns"] for r in by_name["encode.decode_wait"])
    assert encoder[0].timings["decode_wait_s"] == pytest.approx(waits / 1e9, abs=1e-9)


def test_a_traced_extract_writes_the_same_features(encoder, tmp_path):
    from mmgclip_tpu_torch.ingest.encode import ImageFeatureExtractor

    enc, items, _failed = encoder
    ex = ImageFeatureExtractor(enc.config, dataset=[{"image_path": p} for p, _k in items],
                               batch_size=2, device="cpu")
    stores = []
    for traced in (False, True):
        ex.export_dir = str(tmp_path / f"traced_{traced}")
        with torch.profiler.profile(activities=CPU) if traced else contextlib.nullcontext():
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                assert ex.extract() == len(items)
            finally:
                torch.set_num_threads(threads)
        stores.append({p: np.load(ex._export_path(p)) for p, _k in items})
    assert [r["name"] for r in profiling.spans()].count("encode.pass") == 1
    for path, vec in stores[0].items():
        assert np.array_equal(stores[1][path], vec), path
