"""Inference server: JSONL requests on stdin, responses on stdout
(port of the repo's ``serve.py``).

    python -m mmgclip_tpu_torch.serve --experiment_path RUN_DIR [--device cpu]
    python -m mmgclip_tpu_torch.serve --experiment_path RUN_DIR --once '{"op": "ping"}'

Protocol (one JSON object per line):
  {"op": "encode",   "paths": ["/path/a.png", ...]}
  {"op": "classify", "paths": [...] | "features": [[...]] |
                     "features_b64": "<base64 f32>", "class_list": [...]}
  {"op": "report",   "paths": [...] | "exam_dir": "/path/st02", "seed": 42}
  {"op": "ping"}

Responses mirror the request id (if given) and carry "result" or "error".
The TCP / unix-socket front-ends and their micro-batching dispatcher are not
ported yet (ROADMAP.md); ``handle_group`` is the merged forward they use.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

import numpy as np

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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment_path", type=str, required=True,
                        help="Run folder inside outputs/ ('yyyy-mm-dd/XX-XX-XX').")
    parser.add_argument("--once", type=str, default=None,
                        help="Handle a single JSON request and exit.")
    parser.add_argument("--device", type=str, default=None,
                        help="Torch device; default the CUDA card (raises without one).")
    args = parser.parse_args(argv)

    experiment_path = args.experiment_path
    if not os.path.isdir(experiment_path):
        experiment_path = os.path.join("outputs", experiment_path)
    engine = InferenceEngine.from_experiment(experiment_path, device=args.device)
    logger.info("Inference engine ready.")
    try:
        if args.once:
            sys.stdout.write(json.dumps(respond(engine, json.loads(args.once))) + "\n")
            sys.stdout.flush()
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
