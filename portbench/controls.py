"""Controls and planted faults: what each cell's comparison has to reject.

    python -m portbench.controls --control <name> --workload <cell> --seed <n> [<n> ...] [--seconds <s>]

Prints one JSON line a seed, all in one process: the control's name and
the cell's compared numbers as the comparison read them.  The benchmark's own runs never run these.

* ``int8`` (``store.ffdm``): the program's own int8 path
  (``networks.image_encoder.config.quant=int8``), the precision below the
  tower's stated bfloat16, in the program's place.
* ``tf32`` (``train.resnet50``): the program's float32
  matmuls and convolutions with TF32 on, the precision below the stated
  float32.
* ``reference_tf32`` (``train.resnet50``): the plain reference computed
  with TF32 on, put in the program's place.
* ``half_batch`` (``train.resnet50``): a fault planted in the program: each
  step takes the mean loss over the first half of its batch.
* ``altered_answer`` (``store.ffdm``): a fault planted where answers are
  produced: every stored feature has its first element moved by a tenth of
  its largest.
* ``sound``: the program as it stands, for the lower readings.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import sys
import tempfile

import numpy as np

from . import manifest
from .run import Context
from .trace import Spans


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _checks(result) -> dict:
    return {c.name: c.value for c in result.checks}


def int8(ctx) -> dict:
    from .run import run_cell

    ctx.config["overrides"] = list(ctx.config["overrides"]) + ["networks.image_encoder.config.quant=int8"]
    return _checks(run_cell(ctx))


def tf32(ctx) -> dict:
    from .run import run_cell

    ctx.config["tf32"] = True
    return _checks(run_cell(ctx))


def half_batch(ctx) -> dict:
    from mmgclip_tpu_torch.training.experiment import ClassifierExperiment

    from .run import run_cell

    step = ClassifierExperiment._train_step

    def broken(self, image_features, text_features, text_features2):
        half = image_features.shape[0] // 2
        return step(self, image_features[:half], text_features[:half],
                    None if text_features2 is None else text_features2[:half])

    with _patched(ClassifierExperiment, "_train_step", broken):
        return _checks(run_cell(ctx))


def altered_answer(ctx) -> dict:
    from .run import run_cell

    if ctx.traffic["generator"] == "store":
        save = np.save

        def altered(path, array, *args, **kwargs):
            array = np.array(array, copy=True)
            array.reshape(-1)[0] += 0.1 * np.abs(array).max()
            return save(path, array, *args, **kwargs)

        with _patched(np, "save", altered):
            return _checks(run_cell(ctx))
    raise ValueError(f"no answers to alter in {ctx.traffic['generator']!r} traffic")


def reference_tf32(ctx) -> dict:
    """The reference with TF32 on, in the program's place: its steps are
    compared with the float32 reference's as the program's would be, the
    observed ones being those the trainer replays from its graph."""
    from mmgclip_tpu_torch.training.experiment import GRAPH_WARMUP_STEPS

    from .data.vocab import write_vocab
    from .generators import common, train
    from .reference.text import WordPiece

    tr, cj = ctx.traffic, ctx.config
    device = ctx.devices[0]
    text = cj["text_tower"]
    vocab = write_vocab(os.path.join(ctx.workdir, "vocab.txt"), tr["texts"], text["vocab_size"])
    features, text_index, enc = train.bank(ctx.seed, int(tr["bank_rows"]), int(tr["feature_dim"]),
                                           tr["texts"], WordPiece(vocab), text["sequence_length"])
    bert_tree = common.bert_weights(cj, ctx.seed, device, os.path.join(ctx.workdir, "bert.npz"))
    init = train.tower_trees(cj, ctx.seed, device)
    first = GRAPH_WARMUP_STEPS if device.startswith("cuda") else 0
    args = (cj, tr, features, text_index, enc, bert_tree, init, first, int(tr["check_steps"]),
            ctx.seed % (1 << 31), device)
    low = train.reference_steps(*args, tf32=True)
    observed = dict(low, first=first, loss=low["loss"][first:])
    return train.compare(observed, train.reference_steps(*args, at_start=low["start"]),
                         list(low["start"]))


def sound(ctx) -> dict:
    """The program as it stands: the sound runs that set each lower reading."""
    from .run import run_cell

    return _checks(run_cell(ctx))


CONTROLS = {"int8": int8, "tf32": tf32, "reference_tf32": reference_tf32,
            "half_batch": half_batch, "altered_answer": altered_answer, "sound": sound}


def context(workload: str, seed: int, seconds: float, root: str = ".") -> Context:
    bench = manifest.load(root)
    cell = manifest.cell(bench, workload)
    with open(os.path.join(root, manifest.config_entry(bench, cell["config"])["file"]),
              encoding="utf-8") as fh:
        config = json.load(fh)
    with open(manifest.traffic_path(cell["traffic"]), encoding="utf-8") as fh:
        traffic = json.load(fh)
    return Context(cell=cell, config=copy.deepcopy(config), traffic=traffic, seed=seed,
                   seconds=seconds, tracing=False, workdir=tempfile.mkdtemp(prefix="portbench-"),
                   spans=Spans())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--control", choices=sorted(CONTROLS), required=True)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    for seed in args.seed:
        ctx = context(args.workload, seed, args.seconds)
        try:
            numbers = CONTROLS[args.control](ctx)
        finally:
            shutil.rmtree(ctx.workdir, ignore_errors=True)
        print(json.dumps({"control": args.control, "workload": args.workload, "seed": seed,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
