"""The readers of the port's own spans (``device.idle_in_decode_wait.store``,
``device.idle_in_assemble.store``, ``ingest.decode_ms_per_image``) on span
lists built by hand, with known overlaps."""

import pytest

from portbench.run import load_reader

IDLE_WAIT = "device.idle_in_decode_wait.store"
IDLE_ASSEMBLE = "device.idle_in_assemble.store"
DECODE_MS = "ingest.decode_ms_per_image"
READERS = (IDLE_WAIT, IDLE_ASSEMBLE, DECODE_MS)

# (name, start ns, end ns, parent key): two passes of 1,000 ns; device
# intervals of two cards overlapping in pass a; one span under no pass
SPANS = [
    ("encode.pass", 0, 1000, None, "a"),
    ("encode.pass", 2000, 3000, None, "b"),
    ("encode.device", 100, 300, "a", None),
    ("encode.device", 200, 350, "a", None),
    ("encode.device", 500, 700, "a", None),
    ("encode.device", 2100, 2900, "b", None),
    ("encode.decode_wait", 0, 150, "a", None),      # idle 0-100
    ("encode.decode_wait", 650, 800, "a", None),    # idle 700-800
    ("encode.decode_wait", 2000, 2200, "b", None),  # idle 2000-2100
    ("encode.assemble", 300, 400, "a", None),       # idle 350-400
    ("encode.assemble", 400, 550, "a", None),       # idle 400-500
    ("encode.assemble", 2950, 3000, "b", None),     # idle 2950-3000
    ("encode.decode", 0, 10_000_000, "a", None),
    ("encode.decode", 0, 30_000_000, "b", None),
    ("encode.decode", 0, 10 ** 12, "elsewhere", None),
    ("encode.assemble", 5000, 9000, "elsewhere", None),
]
EXPECTED = {IDLE_WAIT: 100.0 * 300 / 2000, IDLE_ASSEMBLE: 100.0 * 200 / 2000, DECODE_MS: 20.0}


@pytest.fixture
def tracer():
    from mmgclip_tpu_torch.utils import profiling

    profiling.reset_spans()
    yield profiling.TRACER
    profiling.reset_spans()


def _record(tracer, spans):
    ids = {"elsewhere": -1}
    for name, start, end, parent, key in spans:
        span_id = tracer.add(name, start, end, ids.get(parent))
        if key:
            ids[key] = span_id


@pytest.mark.parametrize("metric", READERS)
def test_reader_values_on_known_overlaps(tracer, metric):
    _record(tracer, SPANS)
    assert load_reader(metric)({"trace": None, "peaks": None}) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", READERS)
def test_readers_give_nothing_without_a_pass(tracer, metric, monkeypatch):
    from mmgclip_tpu_torch.utils import profiling

    read = load_reader(metric)
    assert read({}) is None
    _record(tracer, [s for s in SPANS if s[0] != "encode.pass"])
    assert read({}) is None
    # a port without the tracer (the parent of the spans): nothing, no error
    monkeypatch.delattr(profiling, "spans")
    assert read({}) is None
