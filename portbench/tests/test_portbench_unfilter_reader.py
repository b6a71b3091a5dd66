"""The reader of ``ingest.card_unfilter_share`` on span lists built by hand:
the share of a pass's decodes marked ``card``, decodes under no pass left
out, and nothing where the port marks no decode (the parent of the mark)."""

import pytest

from portbench.run import load_reader

METRIC = "ingest.card_unfilter_share"


@pytest.fixture
def tracer():
    from mmgclip_tpu_torch.utils import profiling

    profiling.reset_spans()
    yield profiling.TRACER
    profiling.reset_spans()


def _record(tracer, marks, parent=True):
    """One pass (or none) and a decode span per mark (``...`` for no mark)."""
    root = tracer.add("encode.pass", 0, 1000) if parent else -1
    for i, mark in enumerate(marks):
        attrs = {} if mark is ... else {"unfilter": mark}
        tracer.add("encode.decode", i, i + 10, root, item=i, **attrs)
    tracer.add("encode.decode", 0, 5, -1, item=99, unfilter="host")  # under no pass


@pytest.mark.parametrize("marks,share", [(["card"] * 4, 100.0), (["card", "host", "card", None], 50.0),
                                         (["host", "host"], 0.0)])
def test_share_of_decodes_the_card_unfiltered(tracer, marks, share):
    _record(tracer, marks)
    assert load_reader(METRIC)({"trace": None, "peaks": None}) == pytest.approx(share)


def test_nothing_without_a_pass_or_a_mark(tracer, monkeypatch):
    from mmgclip_tpu_torch.utils import profiling

    read = load_reader(METRIC)
    assert read({}) is None
    _record(tracer, ["card", "card"], parent=False)
    assert read({}) is None
    profiling.reset_spans()
    _record(tracer, [..., ...])  # decode spans without the mark: a port that lacks it
    assert read({}) is None
    monkeypatch.delattr(profiling, "spans")  # a port without the tracer
    assert read({}) is None
