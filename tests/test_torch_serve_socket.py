"""The port's socket front-end (``serve.serve_socket``) against the JAX
server's, over the committed demo run.

Both engines serve ``outputs/demo/run`` as in ``tests/test_torch_serving.py``
(the JAX towers written to flax bytes, the port pointed at them), each behind
its own ``serve_socket`` on a unix socket in a thread.  The three socket
tests of ``tests/test_serving.py`` are followed: concurrent pipelining
clients get every response on the right connection with the right id, equal
op by op to the JAX server's (probabilities within 1e-5, report text
exact); an over-limit line gets one error and closes its connection; and
concurrent inline ``classify`` requests are merged into fewer forwards than
requests.  ``_batch_key`` keeps the JAX server's rules.
"""

import asyncio
import contextlib
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

import serve as jax_serve
from fixtures import make_image_id
from mmgclip_tpu_torch import serve
from mmgclip_tpu_torch.config import recompose
from mmgclip_tpu_torch.serving import InferenceEngine
from torch_demo import demo_towers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "outputs", "demo", "run")
PROB_TOL = 1e-5
FEATURE_RTOL = 1e-4
PROMPTS = ["Finding suggesting benign.", "Finding suggesting malignant."]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    (base, _annotated, _lists), jax_engine, text_path, convnext_path = demo_towers(
        str(tmp_path_factory.mktemp("socket")))
    cfg = recompose(RUN)
    cfg.checkpoints.checkpoints_export_dir = os.path.join(RUN, "checkpoints")
    cfg.networks.image_encoder.convnext_tiny_clf_path = convnext_path
    cfg.networks.text_encoder.weights_path = text_path
    engine = InferenceEngine(cfg, device="cpu")
    exam_dir = os.path.join(base, "02", "02000000", "st02")
    pngs = [os.path.join(base, "02", f"{p:08d}", "st02", f"{make_image_id(p, 2, v)}.png")
            for p, v in ((2000000, "cl"), (2100001, "cr"))]
    yield engine, jax_engine, pngs, exam_dir
    engine.close()


@contextlib.contextmanager
def serving(serve_socket, engine, path=None, **kwargs):
    """``serve_socket`` on a unix socket at ``path`` (or on TCP with the
    ``host`` / ``port`` kwargs) in a thread of its own, cancelled (and the
    thread joined) on exit; yields the bound address."""
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    tasks, bound = [], []

    def run():
        asyncio.set_event_loop(loop)
        tasks.append(loop.create_task(serve_socket(engine, unix_path=path, ready_event=ready,
                                                   bound_addr=bound, **kwargs)))
        try:
            loop.run_until_complete(tasks[0])
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert ready.wait(timeout=60)
    try:
        yield bound[0]
    finally:
        loop.call_soon_threadsafe(tasks[0].cancel)
        thread.join(timeout=60)
        assert not thread.is_alive()


def exchange(address, requests):
    """Pipelined: every request written before any response is read."""
    family = socket.AF_UNIX if isinstance(address, str) else socket.AF_INET
    conn = socket.socket(family, socket.SOCK_STREAM)
    conn.settimeout(120)
    conn.connect(address)
    with conn, conn.makefile("rw") as fh:
        for request in requests:
            fh.write(json.dumps(request) + "\n")
        fh.flush()
        return [json.loads(fh.readline()) for _ in requests]


def concurrently(path, per_client):
    results = {}

    def client(i):
        for response in exchange(path, per_client[i]):
            results[response["id"]] = response

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(per_client))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return results


def assert_same(ours, theirs):
    if isinstance(theirs, dict):
        assert set(ours) == set(theirs)
        for key in theirs:
            assert_same(ours[key], theirs[key])
    elif isinstance(theirs, list) and theirs and isinstance(theirs[0], dict):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_same(a, b)
    elif isinstance(theirs, list) and theirs and isinstance(theirs[0], list) and len(theirs[0]) > 8:
        ours, theirs = np.asarray(ours), np.asarray(theirs)  # encode: 768-d features
        assert ours.shape == theirs.shape
        assert np.abs(ours - theirs).max() <= FEATURE_RTOL * np.abs(theirs).max()
    elif isinstance(theirs, list) and theirs and isinstance(theirs[0], list):
        np.testing.assert_allclose(ours, theirs, atol=PROB_TOL, rtol=0)  # probabilities
    else:
        assert ours == theirs


def client_requests(i, pngs, exam_dir, feats):
    import base64

    b64 = base64.b64encode(feats.astype("<f4").tobytes()).decode()
    return [
        {"op": "ping", "id": f"{i}-ping"},
        {"op": "encode", "paths": pngs, "id": f"{i}-encode"},
        {"op": "classify", "paths": pngs, "class_list": PROMPTS, "id": f"{i}-clf-paths"},
        {"op": "classify", "features": feats[i % 2:].tolist(), "class_list": PROMPTS, "id": f"{i}-clf"},
        {"op": "report", "paths": pngs, "seed": 7, "id": f"{i}-report-paths"},
        {"op": "report", "exam_dir": exam_dir, "id": f"{i}-report-exam"},
        {"op": "report", "features_b64": b64, "features_rows": 2, "bug_compat": False,
         "id": f"{i}-report-b64"},
        {"op": "nope", "id": f"{i}-bad"},
    ]


def test_concurrent_clients_answer_as_the_jax_server(engines, tmp_path):
    engine, jax_engine, pngs, exam_dir = engines
    feats = engine.encode_paths(pngs)
    per_client = [client_requests(i, pngs, exam_dir, feats) for i in range(3)]
    with serving(serve.serve_socket, engine, str(tmp_path / "port.sock")) as path:
        ours = concurrently(path, per_client)
    with serving(jax_serve.serve_socket, jax_engine, str(tmp_path / "jax.sock")) as path:
        theirs = concurrently(path, per_client)
    assert set(ours) == set(theirs) == {r["id"] for reqs in per_client for r in reqs}
    for rid, response in theirs.items():
        if rid.endswith("-bad"):
            assert ours[rid] == response == {"id": rid, "error": "Unknown op 'nope'"}
        else:
            assert "result" in response and "result" in ours[rid], (rid, ours[rid], response)
            assert_same(ours[rid]["result"], response["result"])


def test_overlimit_line_closes_the_connection(engines, tmp_path):
    engine = engines[0]
    with serving(serve.serve_socket, engine, str(tmp_path / "mmg.sock"), limit=1024) as path:
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(60)
        conn.connect(path)
        with conn, conn.makefile("rw") as fh:
            # an oversized line whose remainder holds a would-be valid request
            fh.write(json.dumps({"op": "ping", "pad": "x" * 4096}) + "\n")
            fh.write(json.dumps({"op": "ping", "id": "after"}) + "\n")
            fh.flush()
            first = json.loads(fh.readline())
            assert "error" in first and "line too long" in first["error"]
            assert fh.readline() == ""  # closed: the framing cannot be trusted
        assert exchange(path, [{"op": "ping", "id": 1}]) == [{"id": 1, "result": {"ok": True}}]


def test_concurrent_classify_requests_are_merged(engines, tmp_path):
    engine, jax_engine, _pngs, _exam = engines
    rows = []
    original = engine.classify

    def slow_classify(features, class_list):
        rows.append(np.asarray(features).shape[0])
        time.sleep(0.3)  # hold the device so later requests queue up
        return original(features, class_list)

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(8, 768)).astype(np.float32)
    requests = [[{"op": "classify", "id": i, "features": [feats[i].tolist()], "class_list": PROMPTS}]
                for i in range(8)]
    engine.classify = slow_classify
    try:
        with serving(serve.serve_socket, engine, str(tmp_path / "mmg.sock")) as path:
            results = concurrently(path, requests)
    finally:
        del engine.classify
    assert sorted(results) == list(range(8))
    for i in range(8):
        assert_same(results[i]["result"], jax_serve.handle(jax_engine, requests[i][0]))
    assert sum(rows) == 8  # every request's row once, no padding rows
    assert len(rows) < 8 and max(rows) >= 2


def test_tcp_front_end(engines):
    engine, jax_engine, _pngs, _exam = engines
    request = {"op": "classify", "id": 2, "features": [[0.5] * 768], "class_list": PROMPTS}
    with serving(serve.serve_socket, engine, host="127.0.0.1", port=0) as address:
        ping, response = exchange(address, [{"op": "ping", "id": 1}, request])
    assert ping == {"id": 1, "result": {"ok": True}}
    assert_same(response["result"], jax_serve.handle(jax_engine, request))


BATCH_KEY_CASES = [
    {"op": "classify", "features": [[1.0]], "class_list": ["a"]},
    {"op": "classify", "features_b64": "AAAA", "class_list": ["a", "b"]},
    {"op": "report", "features": [[1.0]]},
    {"op": "report", "features": [[1.0]], "seed": 3, "bug_compat": False},
    {"op": "report", "features": [[1.0]], "exam_dir": "/x"},  # exam_dir wins in handle()
    {"op": "report", "features": [[1.0]], "seed": "abc"},  # malformed: not batchable
    {"op": "classify", "features": [[1.0]], "class_list": [["a"]]},  # unhashable
    {"op": "classify", "paths": ["/a.png"], "class_list": ["a"]},  # paths decode on the host
    {"op": "ping"},
]


def test_batch_key_rules():
    keys = [serve._batch_key(request) for request in BATCH_KEY_CASES]
    assert keys == [jax_serve._batch_key(request) for request in BATCH_KEY_CASES]
    assert [key is not None for key in keys] == [True] * 4 + [False] * 5
    assert keys[0] == ("classify", ("a",)) and keys[3] == ("report", 3, False)
