"""Inference server: the JSONL protocol over stdin/stdout or a socket
(port of the repo's ``serve.py``).

    python -m mmgclip_tpu_torch.serve --experiment_path RUN_DIR [--device cpu]
    python -m mmgclip_tpu_torch.serve --experiment_path RUN_DIR --once '{"op": "ping"}'
    python -m mmgclip_tpu_torch.serve --experiment_path RUN_DIR --socket 127.0.0.1:8787
    python -m mmgclip_tpu_torch.serve --experiment_path RUN_DIR --unix /tmp/mmgclip.sock

Protocol (one JSON object per line):
  {"op": "encode",   "paths": ["/path/a.png", ...]}
  {"op": "classify", "paths": [...] | "features": [[...]] |
                     "features_b64": "<base64 f32>", "class_list": [...]}
  {"op": "report",   "paths": [...] | "exam_dir": "/path/st02", "seed": 42}
  {"op": "ping"}

Responses mirror the request id (if given) and carry "result" or "error".

On a socket, connections are served concurrently (one asyncio task each)
while the device work runs on a single executor thread.  Requests that queue
up while the device is busy are micro-batched: coalescible ones (same op and
prompt list or report flags, inline features; ``_batch_key``) merge into one
``handle_group`` forward and the results are split back per request.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .ingest.encode import resolve_device
from .serving import InferenceEngine
from .utils.logging import logger


def _inline_features(engine: InferenceEngine, request: dict) -> np.ndarray:
    """Inline features: a JSON float list ("features") or base64
    little-endian float32 ("features_b64", flat or row-major [n, d])."""
    if "features_b64" in request:
        buf = np.frombuffer(base64.b64decode(request["features_b64"]), dtype="<f4")
        dim = int(engine.cn_config.dims[-1])
        if buf.size == 0 or buf.size % dim:
            raise ValueError(
                f"features_b64 holds {buf.size} float32s, not a multiple of "
                f"the feature dim {dim}")
        rows = buf.size // dim
        if "features_rows" in request:
            expected = int(request["features_rows"])
            if rows != expected:
                raise ValueError(
                    f"features_b64 holds {rows} row(s) of dim {dim}, but "
                    f"features_rows={expected}")
        elif rows > 1:
            logger.info(f"features_b64 promoted to {rows} rows of dim {dim}; pass "
                        "features_rows to make multi-row payloads explicit.")
        return buf.reshape(-1, dim)
    return np.asarray(request["features"], np.float32)


def handle(engine: InferenceEngine, request: dict) -> dict:
    op = request.get("op")
    if op == "ping":
        return {"ok": True}
    if op == "encode":
        feats = engine.encode_paths(request["paths"])
        return {"features": feats.tolist()}
    if op == "classify":
        if "features" in request or "features_b64" in request:
            feats = _inline_features(engine, request)
        else:
            feats = engine.encode_paths(request["paths"])
        return engine.classify(feats, request["class_list"])
    if op == "report":
        if "exam_dir" in request:
            feats = engine.encode_exam(request["exam_dir"])
        elif "features" in request or "features_b64" in request:
            feats = _inline_features(engine, request)
        else:
            feats = engine.encode_paths(request["paths"])
        reports = engine.generate_reports(
            feats, seed=int(request.get("seed", 42)),
            bug_compat=bool(request.get("bug_compat", True)))
        return {"reports": reports}
    raise ValueError(f"Unknown op {op!r}")


def _batch_key(request: dict):
    """Requests coalescible into one device call share a key (None: not
    batchable).  Only inline-feature requests coalesce: path requests decode
    PNGs on the host, which should not hold up the merged forward.  Never
    raises (the dispatcher calls it): a malformed field makes the request
    non-batchable, and ``handle`` reports the error to its client."""
    try:
        op = request.get("op")
        key = None
        inline = "features" in request or "features_b64" in request
        if op == "classify" and inline and "class_list" in request:
            key = ("classify", tuple(request["class_list"]))
        elif op == "report" and inline and "exam_dir" not in request:
            # exam_dir takes precedence over features in handle(): a request
            # carrying both must not answer differently under load
            key = ("report", int(request.get("seed", 42)), bool(request.get("bug_compat", True)))
        if key is not None:
            hash(key)  # nested lists make the tuple unhashable at lookup
        return key
    except (TypeError, ValueError):
        return None


def handle_group(engine: InferenceEngine, requests: list) -> list:
    """One merged forward for inline-feature requests of one op and one
    prompt list / report flags; one result dict per request."""
    if len(requests) == 1:
        return [handle(engine, requests[0])]
    arrays = []
    for request in requests:
        arr = _inline_features(engine, request)
        arrays.append(arr[None, :] if arr.ndim == 1 else arr)
    counts = [arr.shape[0] for arr in arrays]
    merged = np.concatenate(arrays, axis=0)
    op = requests[0]["op"]
    results = []
    start = 0
    if op == "classify":
        out = engine.classify(merged, requests[0]["class_list"])
        for count in counts:
            results.append({
                "classes_similarities": out["classes_similarities"][start:start + count],
                "similarities_argmax": out["similarities_argmax"][start:start + count],
                "class_list": out["class_list"],
            })
            start += count
    else:
        reports = engine.generate_reports(
            merged, seed=int(requests[0].get("seed", 42)),
            bug_compat=bool(requests[0].get("bug_compat", True)))
        for count in counts:
            results.append({"reports": reports[start:start + count]})
            start += count
    return results


def respond(engine: InferenceEngine, request: dict) -> dict:
    """The protocol's response object for one request."""
    rid = request.get("id")
    try:
        return {"id": rid, "result": handle(engine, request)}
    except Exception as exc:  # noqa: BLE001 - protocol boundary
        return {"id": rid, "error": str(exc)}


MAX_BATCH = 32  # requests one dispatcher round drains


async def serve_socket(engine: InferenceEngine, host=None, port=None, unix_path=None,
                       ready_event=None, limit=64 * 1024 * 1024, bound_addr=None):
    """The JSONL protocol over TCP or a unix socket, one task per connection,
    until cancelled.

    Device work runs on one executor thread.  A dispatcher drains whatever
    queued while the previous device call ran (up to ``MAX_BATCH``) and merges
    coalescible requests (``_batch_key``) into one ``handle_group`` call.
    A line longer than ``limit`` gets one error response and closes
    its connection.  ``bound_addr`` (a list) receives the bound address
    (TCP port 0 picks one) before ``ready_event`` is set."""
    loop = asyncio.get_running_loop()
    executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="serve-device")
    queue: asyncio.Queue = asyncio.Queue()
    shutdown = asyncio.Event()

    async def run_items(items):
        requests = [request for request, _fut in items]
        try:
            if len(items) == 1:
                results = [await loop.run_in_executor(executor, handle, engine, requests[0])]
            else:
                results = await loop.run_in_executor(executor, handle_group, engine, requests)
            for (_request, fut), result in zip(items, results):
                if not fut.done():
                    fut.set_result(result)
        except Exception as exc:  # noqa: BLE001 - routed to the clients
            if len(items) == 1:
                if not items[0][1].done():
                    items[0][1].set_exception(exc)
                return
            # one bad request must not fail its batch neighbours: retry each
            # alone, with its own error
            for item in items:
                await run_items([item])

    async def dispatcher():
        while True:
            batch = [await queue.get()]
            try:
                while len(batch) < MAX_BATCH:
                    try:
                        batch.append(queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                groups: dict = {}
                order = []  # groups and singles in arrival order
                for item in batch:
                    key = _batch_key(item[0])
                    if key is None:
                        order.append([item])
                    else:
                        if key not in groups:
                            groups[key] = []
                            order.append(groups[key])
                        groups[key].append(item)
                for items in order:
                    await run_items(items)
            except asyncio.CancelledError:
                # shutdown mid-batch: the in-flight requests would otherwise
                # leave their clients waiting forever
                for _request, fut in batch:
                    if not fut.done():
                        fut.set_exception(ConnectionError("server shutting down"))
                raise
            except Exception as exc:  # noqa: BLE001 - the dispatcher must survive
                for _request, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)

    dispatcher_task = asyncio.ensure_future(dispatcher())

    async def client(reader, writer):
        try:
            while True:
                rid = None
                desynced = False
                try:
                    try:
                        line = await reader.readline()
                    except (ValueError, asyncio.LimitOverrunError) as exc:
                        # the reader still holds the rest of the long line, so
                        # later reads would parse garbage: answer, then close
                        desynced = True
                        raise RuntimeError(f"line too long: {exc}") from exc
                    if not line:
                        break
                    line = line.strip()
                    if not line:
                        continue
                    request = json.loads(line)
                    rid = request.get("id")
                    if shutdown.is_set():
                        # the dispatcher is gone: a request queued now would
                        # never be answered
                        raise ConnectionError("server shutting down")
                    fut = loop.create_future()
                    await queue.put((request, fut))
                    out = {"id": rid, "result": await fut}
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                except Exception as exc:  # noqa: BLE001 - protocol boundary
                    out = {"id": rid, "error": str(exc)}
                try:
                    writer.write((json.dumps(out) + "\n").encode())
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError, ConnectionError):
                    break  # the client went away mid-response
                if desynced:
                    break
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, ConnectionError):
                pass

    # inline features are large JSON lines (768 floats an image): the limit
    # is 64 MiB, not asyncio's 64 KiB default
    if unix_path:
        server = await asyncio.start_unix_server(client, path=unix_path, limit=limit)
    else:
        server = await asyncio.start_server(client, host, port, limit=limit)
    sockname = None if unix_path else server.sockets[0].getsockname()
    if bound_addr is not None:
        bound_addr.append(unix_path or sockname)
    # an abstract unix socket's name starts with NUL, shown as "@"
    where = unix_path.replace("\0", "@") if unix_path else f"{sockname[0]}:{sockname[1]}"
    logger.info(f"Serving JSONL protocol on {where}.")
    if ready_event is not None:
        ready_event.set()
    try:
        # park until cancelled; not serve_forever(), whose exit waits for the
        # connected clients, whose handlers wait on futures only the shutdown
        # below resolves
        await loop.create_future()
    finally:
        shutdown.set()
        server.close()
        dispatcher_task.cancel()
        try:
            await dispatcher_task
        except asyncio.CancelledError:
            pass
        while not queue.empty():  # queued requests get an error, not silence
            _request, fut = queue.get_nowait()
            if not fut.done():
                fut.set_exception(ConnectionError("server shutting down"))
        executor.shutdown(wait=False)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", type=str, required=True,
                        help="Run folder inside outputs/ ('yyyy-mm-dd/XX-XX-XX').")
    parser.add_argument("--once", type=str, default=None,
                        help="Handle a single JSON request and exit.")
    parser.add_argument("--socket", type=str, default=None,
                        help="Serve over TCP: host:port.")
    parser.add_argument("--unix", type=str, default=None,
                        help="Serve over a unix domain socket at this path.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)  # no card and no --device: raise before any work

    experiment_path = args.experiment_path
    if not os.path.isdir(experiment_path):
        experiment_path = os.path.join("outputs", experiment_path)
    engine = InferenceEngine.from_experiment(experiment_path, device=device)
    logger.info("Inference engine ready.")
    try:
        if args.once:
            sys.stdout.write(json.dumps(respond(engine, json.loads(args.once))) + "\n")
            sys.stdout.flush()
            return
        if args.socket:
            host, _, port = args.socket.rpartition(":")
            asyncio.run(serve_socket(engine, host=host or "127.0.0.1", port=int(port)))
            return
        if args.unix:
            asyncio.run(serve_socket(engine, unix_path=args.unix))
            return
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                request = json.loads(line)
            except json.JSONDecodeError as exc:
                # malformed input must not kill the long-running server
                out = {"id": None, "error": f"bad json: {exc}"}
            else:
                out = respond(engine, request)
            sys.stdout.write(json.dumps(out) + "\n")
            sys.stdout.flush()
    finally:
        engine.close()


if __name__ == "__main__":
    main()
