"""The port's pandas-free report pipeline against the JAX package's.

* every text helper of ``data/reports.py`` on ``tests/test_reports_pipeline.py``'s
  cases (and a few more), outputs equal;
* ``preprocess_reports_csv``, ``post_process_translated_report`` and
  ``map_path_to_features`` on the same fixture CSVs, row by row and column
  by column (missing values: ``nan`` there, ``None`` here), and every file
  they export byte-equal.  The raw fixture exercises the quirks: the
  eliminated-reports filter matching column by column (a row made of two
  eliminated rows' values is dropped too), RE2's ASCII classes in the
  regex replacements (a vertical tab, an accented letter), a missing
  exam date sorted last;
* ``csv_table`` reads pandas-written CSVs to the same rows, missing values
  included, and writes the fixture tables byte-equal to pandas.

pandas (3.0.3 here) runs the JAX side only.
"""

import glob
import os

import numpy as np
import pandas as pd
import pytest

from fixtures import build_study_report_fixture
from mmgclip_tpu.config import Config as JaxConfig
from mmgclip_tpu.data import reports as jax_reports
from mmgclip_tpu_torch.config import Config
from mmgclip_tpu_torch.data import reports
from mmgclip_tpu_torch.data.csv_table import Table, append_text_column, read_csv, write_csv

HEADER = "Report MG 2020-01-01 1.2.3 2020-01-01 10:00:00.0000000+01:00 READ Finalized "


def jax_took_the_regex_splitter() -> bool:
    try:
        import nltk

        nltk.sent_tokenize("One. Two.")
    except LookupError:
        return True
    except ImportError:
        return True
    return False


HELPER_CASES = [
    ("roman_to_int", ("BIRADS IV category",)),
    ("roman_to_int", ("stage III and II",)),
    ("roman_to_int", ("no numerals here",)),
    ("replace_dutch_numbers", ("BI-RADS twee.",)),
    ("replace_dutch_numbers", ("score vier",)),
    ("extract_labels", ("Conclusie BI-RADS 4", 1, "")),
    ("extract_labels", ("birads twee", 1, "")),
    ("extract_labels", ("BIRADS classificatie 5", 0, "")),
    ("extract_labels", ("geen classificatie", 0, "")),
    ("extract_labels", ("BI-RADS 3", 0, "Er is een ovaalvormige massa met gegroepeerde kalk zichtbaar.")),
    ("find_similar_words", ("nothing matches here", ["hyperdens"], 0.7)),
    ("find_similar_words", ("een hypodense laesie", ["hyperdens", "isodens", "hypodens"], 0.7)),
    ("extract_report", (HEADER + "Mammografie beiderzijds. Conclusie BI-RADS 2.",)),
    ("find_sentences_with_keyword", ("Eerste zin. Er is maligniteit aanwezig. Laatste zin.", ["maligniteit"])),
    ("find_sentences_with_keyword", ("Eerste zin. Laatste zin.", ["afwezig-term"], True)),
    ("remove_duplicate_sentences", ("B comes first. A second. B comes first. C third.",)),
    ("remove_duplicate_sentences", ("Dr. Smith came! Dr. Smith came! Why?  Why?",)),
    ("remove_extra_spaces", ("a   b\t\nc",)),
    ("remove_text_before_word", ("x Finalized rest of it", "Finalized")),
]


@pytest.mark.parametrize("name,args", HELPER_CASES,
                         ids=[f"{n}-{i}" for i, (n, _a) in enumerate(HELPER_CASES)])
def test_helpers_match_jax(name, args):
    if name == "remove_duplicate_sentences" and not jax_took_the_regex_splitter():
        pytest.skip("nltk's punkt is installed: the JAX package splits sentences with it")
    assert getattr(reports, name)(*args) == getattr(jax_reports, name)(*args)


def test_translate_labels_matches_jax():
    for args in [("BI-RADS 3", 0, "ovaalvormige massa, gegroepeerde kalk, hyperdens"),
                 ("BI-RADS V", 1, "irregulaire massa met fijn lineair kalk, segmenteel")]:
        assert reports.translate_labels(reports.extract_labels(*args)) == \
            jax_reports.translate_labels(jax_reports.extract_labels(*args))


# ----------------------------------------------------------------------
# the pipeline on fixture CSVs

def raw_rows():
    rows = [
        ("T20-001", "02000001", "2020-01-01", "2020-01-01", "MG", "malignant", "<st0>DCIS</st0>",
         "verdacht*gebied", HEADER + "Er is een irregulaire massa. Conclusie maligniteit. BI-RADS V."),
        ("T20-002", "02000002", "2020-01-02", "2020-01-02", "MG", "NotMalignant", "geen", "normaal",
         HEADER + "Mammogram zonder afwijkingen. Conclusie benigne. BI-RADS twee."),
        ("T20-003", "02000001", "2020-01-03", "2020-01-03", "US", "NotMalignant", "-", "-",
         HEADER + "Echografie."),
        # eliminated by its key
        ("T20-004", "02000003", "2020-01-04", "2020-01-04", "MG", "malignant", "x", "y",
         HEADER + "Eliminated one. BI-RADS 4."),
        ("T20-005", "02000004", "2020-01-05", "2020-01-05", "MG", "malignant", "x", "y",
         HEADER + "Eliminated two. BI-RADS 4."),
        # not eliminated, but every value occurs in an eliminated row's column: dropped (quirk)
        ("T20-004", "02000004", "2020-01-04", "2020-01-05", "MG", "malignant", "x", "y",
         HEADER + "Eliminated two. BI-RADS 4."),
        # RE2 classes: a vertical tab before and an accented letter after a pathology reference
        ("T20-006", "02000002", "2020-01-06", None, "MG", "malignant",
         "Zie ook\x0bT20-123 (abc) T21-001 (éa) rest", "imp*",
         HEADER + "Zie ook T19-555 (xyz) massa. Conclusie BI-RADS IV. Tweede conclusie."),
        ("T20-007", "02000001", "2020-01-07", "2019-12-31", "MG", "malignant", "p", "i",
         "Report US 2020-01-01 1.2 2020-01-01 10:00:00.0000000+01:00 Finalized ## "
         "Report current MGOT iets. Medische gegevens: Conclusie benigne"),
        ("T20-008", "02000002", "2020-01-08", "2020-01-08", "MG", "malignant", "p", "-",
         "-- "),
    ]
    columns = ["raw_id", "patient_id", "report_date", "exam_date", "modality", "is_malig",
               "pathology", "impression", "report"]
    return pd.DataFrame(rows, columns=columns)


@pytest.fixture
def workspace(tmp_path):
    lists = tmp_path / "lists"
    lists.mkdir()
    (lists / "normal_patients.txt").write_text("patient_id\n02000002\n")
    (lists / "malignant_patients.txt").write_text("patient_id\n02000001\n02000003\n02000004\nNA\n")
    eliminate = tmp_path / "eliminate.csv"
    eliminate.write_text("T20-004,02000003,2020-01-04\nT20-005,02000004,2020-01-05\n")
    tree = {"dataset": {"config": {"lists_dataset_path": str(lists),
                                   "eliminated_reports_path": str(eliminate),
                                   "base_dataset_path": str(tmp_path / "base" / "2D_100micron")}},
            "base": {"features_export_dir": str(tmp_path / "features")}}
    return tmp_path, JaxConfig(tree), Config(tree)


def assert_same_table(ours: Table, theirs: pd.DataFrame):
    assert ours.columns == list(theirs.columns)
    assert ours.index == list(theirs.index)
    for row, (_label, their_row) in zip(ours.rows, theirs.iterrows()):
        for column in ours.columns:
            value, expected = row[column], their_row[column]
            if expected is None or (isinstance(expected, float) and np.isnan(expected)):
                assert value is None, (column, value)
            else:
                assert value == expected, (column, value, expected)


def exported(root, pattern):
    (path,) = glob.glob(os.path.join(root, pattern))
    with open(path, "rb") as fh:
        return fh.read()


def test_preprocess_reports_csv_matches_jax(workspace, monkeypatch):
    tmp_path, jcfg, cfg = workspace
    raw = tmp_path / "raw.csv"
    raw_rows().to_csv(raw, index=False)
    out = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            out[side] = jax_reports.preprocess_reports_csv(pd.read_csv(raw, dtype=str), jcfg, export=True)
        else:
            out[side] = reports.preprocess_reports_csv(read_csv(str(raw)), cfg, export=True)
    theirs, ours = out["jax"], out["port"]
    assert len(ours) == 5  # the US row, both eliminated rows and the quirk's row dropped
    assert_same_table(ours, theirs)
    # stable by (patient_id, exam_date), the missing date last; an emptied report is missing
    assert [r["exam_date"] for r in ours.rows] == ["2019-12-31", "2020-01-01", "2020-01-02",
                                                   "2020-01-08", None]
    assert [r["report_preprocessed"] is None for r in ours.rows] == [False, False, False, True, False]
    for name in ("processed_reports.csv", "nl_reports_only.txt"):
        assert exported(tmp_path / "port", f"data/*/*/{name}") == \
            exported(tmp_path / "jax", f"data/*/*/{name}"), name


def translated_rows():
    return pd.DataFrame({
        "patient_id": ["2000001", "2000002", "2000003", "2000004"],
        "study_id": ["st02", "st02", "st01", "st02"],
        "is_malig": ["1", "0", "1", "0"],
        "labels": [str({"birads": "4", "masses": {"shapes": "oval"}})] * 4,
        "impression_en": ["The lesion. The lesion.", None, "x", "Imp, with comma"],
        "report_en": ["Report shows malignancy. Report shows malignancy. BI-RADS 4 één",
                      "#VALUE!", "Note: a-b... \"\"quoted\"\"", "Plain."],
    })


def test_post_process_and_map_features_match_jax(workspace, monkeypatch):
    tmp_path, jcfg, cfg = workspace
    translated = tmp_path / "translated.csv"
    translated_rows().to_csv(translated)
    out = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        if side == "jax":
            df = pd.read_csv(translated, dtype=str, index_col=0)
            out[side] = jax_reports.post_process_translated_report(df, jcfg, export=True,
                                                                   export_dir="post")
        else:
            out[side] = reports.post_process_translated_report(read_csv(str(translated), index_col=0),
                                                               cfg, export=True, export_dir="post")
    assert_same_table(out["port"], out["jax"])
    assert out["port"].index == ["0", "2", "3"]  # the "#VALUE!" row filtered, labels kept
    for name in ("postprocessed_tr_dataset.csv", "en_reports_only.txt", "en_impression_only.txt"):
        assert exported(tmp_path / "port", f"post/{name}") == exported(tmp_path / "jax", f"post/{name}")

    # stored features for two of the three studies (.npy and .pth)
    for pid, suffix in (("02000001", ".npy"), ("02000004", ".pth")):
        path = tmp_path / "features" / "02" / pid / "st02" / f"{pid}{suffix}"
        path.parent.mkdir(parents=True)
        path.write_bytes(b"")
    mapped = {}
    for side in ("jax", "port"):
        monkeypatch.chdir(tmp_path / side)
        fn = jax_reports.map_path_to_features if side == "jax" else reports.map_path_to_features
        cfg_side = jcfg if side == "jax" else cfg
        mapped[side] = fn(out[side], cfg_side, export=True, export_dir="final")
    assert len(mapped["port"]) == 2
    assert_same_table(mapped["port"], mapped["jax"])
    assert exported(tmp_path / "port", "final/final_reports_dataset.csv") == \
        exported(tmp_path / "jax", "final/final_reports_dataset.csv")


# ----------------------------------------------------------------------
# csv_table

def test_read_csv_reads_pandas_csvs_to_the_same_rows(tmp_path):
    frame = pd.DataFrame({
        "a": ["x", "", "NA", "nan", "NULL", "None", "#N/A", "n/a", "keep me", "q,1"],
        "b": ['say "hi"', "multi\nline", " lead", "trail ", "-nan", "null", "<NA>", "1.#IND", "ok", "é"],
        "c": list(range(10)),
    }, index=[f"r{i}" for i in range(10)])
    for index_col, kwargs in ((None, {"index": False}), (0, {})):
        for encoding in ("utf-8", "latin1"):
            path = tmp_path / f"t_{index_col}_{encoding}.csv"
            frame.to_csv(path, encoding=encoding, **kwargs)
            for read_encoding in {encoding, "unicode_escape" if encoding == "latin1" else encoding}:
                theirs = pd.read_csv(path, dtype=str, index_col=index_col, encoding=read_encoding)
                ours = read_csv(str(path), index_col=index_col, encoding=read_encoding)
                assert_same_table(ours, theirs)
    (tmp_path / "blank.csv").write_text("a,b\n1,2\n\n3,\n")
    ours = read_csv(str(tmp_path / "blank.csv"))
    assert ours.rows == [{"a": "1", "b": "2"}, {"a": "3", "b": None}]


def test_write_csv_is_byte_equal_to_pandas_on_the_fixture_tables(tmp_path):
    reports_csv, gtr_csv, _features = build_study_report_fixture(str(tmp_path / "fx"), n_studies=6)
    raw = tmp_path / "raw.csv"
    raw_rows().to_csv(raw, index=False)
    for path, index_col in ((reports_csv, 0), (gtr_csv, None), (str(raw), None)):
        for encoding in ("utf-8", "latin1"):
            theirs, ours = tmp_path / "theirs.csv", tmp_path / "ours.csv"
            pd.read_csv(path, dtype=str, index_col=index_col).to_csv(theirs, encoding=encoding)
            write_csv(str(ours), read_csv(path, index_col=index_col), encoding=encoding)
            assert ours.read_bytes() == theirs.read_bytes(), (path, encoding)
            for column in ("image_description", "gtr_path", "report"):
                frame = pd.read_csv(path, dtype=str, index_col=index_col)
                if column in frame.columns:
                    theirs.unlink()
                    ours.unlink()
                    frame[column].to_csv(theirs, index=False, header=False, sep=" ", mode="a")
                    append_text_column(str(ours), read_csv(path, index_col=index_col).column(column))
                    assert ours.read_bytes() == theirs.read_bytes(), (path, column)
