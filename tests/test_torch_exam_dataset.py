"""The port's ``StudyReportDataset`` against the JAX package's on
``tests/fixtures.py::build_study_report_fixture``: in the three GTR modes
(reports only, reports + prompts, prompts only) and with
``gtr_bug_compat: false``, the supervision text, the description and
impression token ids, ``prompt_labels`` and the ``image_description.txt``
dump are bit-equal; the study features, the seeded splits and a collated
batch are equal.  A missing report cell reads as "" in both.
"""

import os

import numpy as np
import pandas as pd
import pytest

from fixtures import build_study_report_fixture
from mmgclip_tpu.config import Config as JaxConfig
from mmgclip_tpu.data.datasets import StudyReportDataset as JaxStudyReportDataset
from mmgclip_tpu_torch.config import Config
from mmgclip_tpu_torch.data.datasets import StudyReportDataset, get_dataset

SEED = 1234
MODES = [(False, False, True), (True, False, True), (True, True, True), (True, True, False)]
IDS = ["reports-only", "reports+prompts", "prompts-only", "prompts-only-semantic"]


@pytest.fixture(scope="module")
def fixture_csvs(tmp_path_factory):
    root = tmp_path_factory.mktemp("exam_ds")
    reports_csv, gtr_csv, _features = build_study_report_fixture(str(root), n_studies=12)
    frame = pd.read_csv(reports_csv, index_col=0, dtype=str)
    frame.loc[frame.index[3], "image_description"] = np.nan  # an empty report cell
    frame.loc[frame.index[5], "image_impression"] = np.nan
    frame.to_csv(reports_csv)
    return reports_csv, gtr_csv


def config(cls, fixture_csvs, export_dir, gtr_generation, prompts_only, bug_compat):
    reports_csv, gtr_csv = fixture_csvs
    return cls({
        "base": {"seed": SEED, "features_export_dir": os.path.dirname(reports_csv),
                 "export_dir": str(export_dir)},
        "dataset": {"name": "StudyReportDataset",
                    "config": {"final_reports_dataset_path": reports_csv, "gt_path": gtr_csv,
                               "gtr_prompt_generation": gtr_generation,
                               "use_gtr_prompts_only": prompts_only,
                               "gtr_bug_compat": bug_compat},
                    "split": {"train_split_ratio": 0.7, "test_split_ratio": 0.5}},
        "tokenizer": {"config": {"tokenizer_name": "emilyalsentzer/Bio_ClinicalBERT",
                                 "sequence_length": 32}},
    })


@pytest.fixture(scope="module", params=MODES, ids=IDS)
def both(request, fixture_csvs, tmp_path_factory):
    root = tmp_path_factory.mktemp("exam_ds_mode")
    theirs = JaxStudyReportDataset(config(JaxConfig, fixture_csvs, root / "jax", *request.param))
    ours = StudyReportDataset(config(Config, fixture_csvs, root / "port", *request.param))
    return theirs, ours, root, request.param


def test_supervision_is_bit_equal(both):
    theirs, ours, root, (gtr_generation, prompts_only, bug_compat) = both
    frame = theirs.final_reports_dataset
    assert len(ours) == len(theirs) > 0
    assert [r["image_description"] for r in ours.rows] == frame["image_description"].tolist()
    assert [r["image_impression"] for r in ours.rows] == frame["image_impression"].tolist()
    assert ours._prompt_labels == theirs._prompt_labels
    for bank in ("_tokens", "_impression_tokens"):
        a, b = getattr(ours, bank), getattr(theirs, bank)
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{bank}.{key}")
    dumps = [(root / side / "image_description.txt").read_bytes() for side in ("port", "jax")]
    assert dumps[0] == dumps[1]
    text = " ".join(r["image_description"] for r in ours.rows)
    if gtr_generation:
        # quirk gtr_bug_compat: the architectural-distortion prompt only without it
        assert ("distortion" in text) == (not bug_compat)
    if not gtr_generation:  # the empty cell reads as "" (no 'nan' text)
        assert ours.rows[3]["image_description"] == ""


def test_features_splits_and_collate_are_equal(both):
    theirs, ours, _root, _mode = both
    np.testing.assert_array_equal(ours._features, theirs._features)
    for split in ("train", "test"):
        a, b = ours.random_split(ours, split), theirs.random_split(theirs, split)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x.indices), np.asarray(y.indices))
    picks = [len(ours) - 1, 0, 2]
    got = ours.collate_fn([ours[i] for i in picks])
    want = theirs.collate_fn([theirs[i] for i in picks])
    assert set(got) == set(want)
    for key in ("text_tokens", "image_impression_tokens"):
        for name in want[key]:
            np.testing.assert_array_equal(got[key][name], want[key][name])
    for key in ("indices", "image_features", "image_label"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("image_description", "image_id", "prompt_labels"):
        assert got[key] == want[key], key


def test_get_dataset_registers_the_exam_dataset():
    assert get_dataset("StudyReportDataset") is StudyReportDataset


def test_count_report_len_reads_the_dump_as_jax_does(both, capsys, monkeypatch):
    from mmgclip_tpu.utils import count_report_len as jax_count
    from mmgclip_tpu_torch.utils import count_report_len

    _theirs, _ours, root, _mode = both
    dump = str(root / "port" / "image_description.txt")
    with open(dump) as fh:
        lines = fh.readlines()
    assert count_report_len.report_length_stats(lines) == jax_count.report_length_stats(lines)
    monkeypatch.setattr("sys.argv", ["count_report_len", "--file_path", dump])
    printed = []
    for module in (count_report_len, jax_count):
        module.main()
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "Total number of reports" in printed[0]
