"""Dutch radiology-report preprocessing pipeline over row tables (port of
mmgclip_tpu/data/reports.py; reference: mmgclip/utils/data_utils.py:295-919).

Section extraction, keyword sentence mining, Dutch-number and Roman-numeral
normalization, fuzzy Dutch keyword -> BI-RADS label extraction, NL->EN label
casting, PHI/boilerplate removal, duplicate-sentence removal,
post-translation cleanup and feature-path mapping, over ``csv_table.Table``
rows where the JAX package holds DataFrames.  The outputs (rows, columns,
index labels and the exported CSV bytes) are the JAX package's under pandas
3.0.3, quirks included:

* the eliminated-reports filter matches column by column, not row by row
  (``df.isin(common.to_dict("list")).all(axis=1)``), and drops by index
  label;
* pandas 3 stores these columns as pyarrow strings, so its
  ``str.replace(..., regex=True)`` runs RE2, whose ``\\d``, ``\\s`` and ``\\w``
  are ASCII (``\\s`` without ``\\v``): the two patterns below spell those
  classes out;
* the sort by ``(patient_id, exam_date)`` is stable with missing values last.

Sentences split with the regex splitter only (nltk's punkt is not used).
"""

from __future__ import annotations

import difflib
import os
import re
import time
from typing import Dict, List, Optional, Union

from ..utils.seeding import create_directory_if_not_exists
from .csv_table import Table, append_text_column, read_csv, write_csv

# ----------------------------------------------------------------------
# sentence utilities
# ----------------------------------------------------------------------

_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def _sent_tokenize(text: str) -> List[str]:
    """The JAX package's splitter where nltk's punkt data is absent (the card's
    machine has no nltk): split after ``.``, ``!`` or ``?`` plus whitespace."""
    return [s for s in _SENT_RE.split(text) if s]


def remove_duplicate_sentences(text: str) -> str:
    """Order-preserving sentence dedup (reference: data_utils.py:788-812)."""
    seen = set()
    unique: List[str] = []
    for sentence in _sent_tokenize(text):
        if sentence not in seen:
            unique.append(sentence)
            seen.add(sentence)
    return " ".join(unique)


# ----------------------------------------------------------------------
# NL normalization helpers (reference: data_utils.py:360-466)
# ----------------------------------------------------------------------

_DUTCH_NUMBERS = {"nul": 0, "een": 1, "twee": 2, "drie": 3, "vier": 4, "vijf": 5, "zes": 6}
_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}
_BIRADS_RE = re.compile(
    r"\b(?:birads|bi[-\s]rads)[-a-zA-Z]*\b(?:\s+\w+)*?[-\s]*(\d+)(?:\s*([A-Z])\b)?",
    re.IGNORECASE,
)


def replace_dutch_numbers(sentence: str) -> str:
    words = sentence.replace(".", "").split()
    return " ".join(str(_DUTCH_NUMBERS.get(w.lower(), w)) for w in words)


def roman_to_int(text: str) -> str:
    def repl(match):
        result, prev = 0, 0
        for ch in match.group(0):
            value = _ROMAN_VALUES[ch.upper()]
            result += value - 2 * prev if value > prev else value
            prev = value
        return str(result)

    return re.sub(r"\b([IVXLCDM]+)\b", repl, text)


def remove_extra_spaces(text: str) -> str:
    return re.sub(r"\s+", " ", text)


def remove_text_before_word(sentence: str, word: str) -> str:
    index = sentence.find(word)
    return sentence[index + len(word) + 1 :] if index != -1 else sentence


def find_sentences_with_keyword(text: str, keywords: List[str], return_str: bool = False):
    sentences = text.split(".")
    matched: List[str] = []
    for keyword in keywords:
        for sentence in sentences:
            if keyword.lower() in sentence.lower() and sentence not in matched:
                matched.append(sentence)
    if return_str:
        return " ".join(matched) if matched else "Unknown"
    return matched if matched else ["Unknown"]


_SPECIAL_KEYWORD_CASTS = {
    "ovaalvormige": "ovaal",
    "diffuus verspreid": "verspreid",
    "grof heterogeen": "heterogeen",
    "heterogene": "heterogeen",
    "fine pleomorphic": "pleomorphic",
}


def find_similar_words(paragraph: str, keywords: List[str], threshold: float = 0.7):
    """Fuzzy keyword spotting (reference: data_utils.py:413-440)."""
    tokens = paragraph.split()
    for keyword in keywords:
        for token in tokens:
            similarity = difflib.SequenceMatcher(None, keyword, token).ratio()
            if similarity >= threshold:
                return (token, similarity, _SPECIAL_KEYWORD_CASTS.get(keyword, keyword))
    return ("", "", "unknown")


def extract_labels(birads: str, malig, report: str) -> Dict:
    match = _BIRADS_RE.search(replace_dutch_numbers(birads))
    labels: Dict = {
        "birads": match.group(1) if match else "unknown",
        "malignancy": malig,
        "masses": {
            "shapes": find_similar_words(report, ["ovaal", "ovaalvormige", "irregulair", "rond"], 0.7)[-1],
            "density": find_similar_words(report, ["hyperdens", "isodens", "hypodens", "lucent"], 0.7)[-1],
        },
        "calcifications": {
            "distribution": find_similar_words(
                report,
                ["diffuus", "diffuus verspreid", "regionaal", "gegroepeerd", "lineair", "segmenteel"],
                0.65,
            )[-1],
            "morphology": find_similar_words(
                report,
                ["amorf", "grof heterogeen", "heterogeen", "heterogene", "Fine pleomorphic",
                 "pleomorphic", "fijn lineair", "lineair vertakkend"],
                0.65,
            )[-1],
        },
    }
    return labels


_NL_EN = {
    "masses": {
        "shapes": {"ovaal": "oval", "rond": "round", "irregulair": "irregular", "unknown": "unknown"},
        "density": {
            "hyperdens": "high density", "isodens": "equal density",
            "hypodens": "low density", "lucent": "fat-containing", "unknown": "unknown",
        },
    },
    "calcifications": {
        "distribution": {
            "diffuus": "diffuse", "verspreid": "diffuse", "regionaal": "regional",
            "gegroepeerd": "grouped", "lineair": "linear", "segmenteel": "segmental",
            "unknown": "unknown",
        },
        "morphology": {
            "amorf": "amorphous", "heterogeen": "coarse heterogeneous",
            "pleomorphic": "fine pleomorphic", "fijn lineair": "fine linear",
            "lineair vertakkend": "fine-linear branching", "unknown": "unknown",
        },
    },
}


def translate_labels(labels: Dict) -> Dict:
    """NL -> BI-RADS EN wording (reference: data_utils.py:468-526)."""

    def replace(original: Dict, table: Dict) -> Dict:
        for key, value in original.items():
            if isinstance(value, dict):
                replace(value, table.get(key, {}))
            else:
                lookup = value.lower() if isinstance(value, str) else value
                original[key] = table.get(key, {}).get(lookup, value)
        return original

    return replace(labels, _NL_EN)


# ----------------------------------------------------------------------
# report extraction (reference: data_utils.py:308-331)
# ----------------------------------------------------------------------

_SECTION_REMOVE_RE = re.compile(
    r"Report\s(?:US|OTUS|MROT|MGOT)\s\d{4}-\d{2}-\d{2}(?::\s##)?\s[\d.]+\s"
    r"\d{4}-\d{2}-\d{2}\s\d{2}:\d{2}:\d{2}\.\d+\+\d{2}:\d{2}\s(?:READ|ARRIVED)?\s?Finalized\s(.+?)(?=##)",
    re.MULTILINE,
)
_HEADER_RE = re.compile(r"Report\s(.+?)Finalized\s", re.MULTILINE)


def extract_report(report: str) -> str:
    cleaned = _SECTION_REMOVE_RE.sub("", report)
    return _HEADER_RE.sub("", cleaned)


# NOTE: two adjacent string literals below concatenate ("## ##" "ADDENDUM" and
# the "...pathologie" pair) — reproducing the reference's own missing-comma
# artifacts (reference: data_utils.py:559-560, 613-614) so the removal set
# matches byte-for-byte.
_KEYWORDS_TO_REMOVE = [
    "Medische gegevens:", " Medische gegevens:", "Medische gegevens:   ",
    "-------------------------------------------------Addendum   start---------------------------------------------",
    "-------------------------------------------------Addendum   einde----------------------------------------",
    "   -------------------------------------------------Addendum   einde-------------------------------------------- ",
    "##", "## ##" "ADDENDUM", "ADDENDUM:", "----", "   /", "Addendum: ", "Addendum:   ",
    "ANON Klinische gegevens", "HITGE-BOETESC Medische gegevens:",
    "HITGE-BOETESC Medische gegevens:   ", "HITGE-BOETESC", "MRW ENGELBRECHT",
    "ANON Medische gegevens",
    "AARTS Medische gegevens Bij bevolkingsonderzoek afwijkingen links.",
    "AARTS Medische gegevens PatiÃ«nt overgekomen uit Veghel.",
    "AARTS Medische gegevens via bevolkingsonderzoek in verband met afwijking in de linkermamma.",
    "ANON ", "ANON Klinische gegevens ", "BOKHOVEN VSC Medische gegevens. ",
    "Medische gegevens", "Medische gegevens.", "Medische gegevens. ",
    "WILLIAMSVAN Klinische informatie ", "WILLIAMSVAN Klinische ",
    "WILLIAMSVAN Medische gegevens ", "WILLIAMSVAN ", "IMHOF-TASMW ", "MUSRDM ",
    "VELTMANJ ", "MEIJERFJA ", "HITGE-BOETESC ", "JAFARIK ",
    "This is a summary report. The complete report is available in the patient''s medical record. "
    "If you cannot access the medical record, please contact the sending organization for a detailed fax or copy. ",
    "FÃTTERERJJ", "PLOEGMAKERSM ", "FÜTTERERJJ Medische gegevens:", "FÃTTERERJJ",
    "DIE VCE", "false false Digital ", "IMHOF-TASMW",
    "Specimen   opnamen ten behoeve van pathologie.",
    "Specimen opnamen ten behoeve van pathologie.", "DIJK VANR", "IMHOF-TASMW",
    "Specimen opnamen ten behoeve van pathologie.",
    "Specimen opname ten behoeve van   pathologie", "Addendum start", "-Addendum start-",
    "STOUTJESDIJKMJ", "SPAARGARENGJ",
    "Specimen opnamen ten behoeve van de PA.", "Specimen opnamen ten behoeve van de   PA.",
    "Specimen opnamen ten behoeve van pathologie" "Specimen opnamen ten behoeve van   pathologie",
    "-- ", "--", " -- ", "Controle.", "Familieanamnese negatief.", "FEUTHL", "FA /",
]

_KEYWORDS_TO_REPLACE = ["   ", "  ", "    ", " . ", " .", ">>", "  >>  ", ": "]

# pandas' RE2 spelling of the JAX package's two ``str.replace(regex=True)``
# patterns (``\d`` -> [0-9], ``\s`` -> [\t\n\f\r ], ``\w`` -> [0-9A-Za-z_])
_D, _S, _W = "[0-9]", r"[\t\n\f\r ]", "[0-9A-Za-z_]"
_TIMESTAMP_RE = re.compile(
    rf"{_D}{{4}}-{_D}{{2}}-{_D}{{2}}{_S}{_D}{{2}}:{_D}{{2}}:{_D}{{2}}\.{_D}{{7}}\+{_D}{{2}}:{_D}{{2}}{_S}0")
_PATHOLOGY_REF_RE = re.compile(rf"(?:Zie ook{_S})?T{_D}{{2}}-{_D}{{3}}{_S}?\(?{_W}*\)?")

_BROKEN_FINALIZED = [
    ("READFinali zed", " READ Finalized "), ("READFinal ized", " READ Finalized "),
    ("READFinaliz ed", " READ Finalized "), ("ARRIVEDFi nalized", " ARRIVED Finalized "),
    ("00Finalized", "00 Finalized "), ("00Finaliz   ed", "00 Finalized "),
    ("00F   inalized", "00 Finalized "), ("00F inalized", "00 Finalized "),
    ("00Finaliz ed", "00 Finalized "),
]


def _as_table(rows: Union[Table, List[Dict]]) -> Table:
    return rows.copy() if isinstance(rows, Table) else Table.from_rows(rows)


def _map(table: Table, column: str, fn) -> None:
    """``df[column] = df[column].apply(fn)``."""
    table.set_column(column, [fn(v) for v in table.column(column)])


def _str_replace(table: Table, column: str, old, new: str) -> None:
    """``df[column].str.replace(old, new)``: missing values stay missing."""
    if isinstance(old, str):
        fn = lambda v: v.replace(old, new)  # noqa: E731
    else:
        fn = lambda v: old.sub(new, v)  # noqa: E731
    _map(table, column, lambda v: v if v is None else fn(v))


def _section(report: str, keywords: List[str], roman: bool = False) -> str:
    sentence = find_sentences_with_keyword(report, keywords)[-1]
    return remove_text_before_word(roman_to_int(sentence) if roman else sentence, "Finalized")


def _validate_report(row: Dict) -> None:
    """Append mined NL sections missing from the processed text
    (reference: data_utils.py:528-549); an empty report becomes missing."""
    malig, conclusion, birads = (row["malignancy_benign_section_nl"], row["conclusion_nl"],
                                 row["birads_section_nl"])
    if malig.lower() != "unknown" and malig.lower() not in row["report_preprocessed"].lower():
        row["report_preprocessed"] += f" {malig}"
    if conclusion.lower() != "unknown" and (
        conclusion.lower() not in row["report_preprocessed"].lower()
        and "conclusie" not in row["report_preprocessed"].lower()
    ):
        row["report_preprocessed"] += f" {conclusion}"
    if birads.lower() != "unknown" and birads.lower() not in row["report_preprocessed"].lower():
        row["report_preprocessed"] += f" {birads}"
    if row["report_preprocessed"] == "":
        row["report_preprocessed"] = None


def preprocess_reports_csv(df: Union[Table, List[Dict]], config, export: bool = False) -> Table:
    """Raw report rows -> translation-ready table (reference: data_utils.py:295-786)."""
    df = _as_table(df)
    keys = ["raw_id", "patient_id", "report_date"]
    eliminated = read_csv(config.dataset.config.eliminated_reports_path, names=keys)
    eliminated_keys = {tuple(row[k] for k in keys) for row in eliminated.rows}
    common = [row for row in df.rows if tuple(row[k] for k in keys) in eliminated_keys]
    common_values = {c: {row[c] for row in common} for c in df.columns}
    drop = {label for label, row in zip(df.index, df.rows)
            if all(row[c] in common_values[c] for c in df.columns)}
    df = df.select(label not in drop for label in df.index)

    df = df.select(row["patient_id"] is not None for row in df.rows)
    df = df.select(row["modality"] == "MG" for row in df.rows)
    df.drop_column("modality")

    lists_path = config.dataset.config.lists_dataset_path
    listed = set(read_csv(lists_path + "/normal_patients.txt", sep=" ").column("patient_id"))
    listed |= set(read_csv(lists_path + "/malignant_patients.txt", sep=" ").column("patient_id"))
    df = df.select(row["patient_id"] in listed for row in df.rows).reset_index()

    _map(df, "is_malig", lambda x: 1 if x == "malignant" else 0)
    _map(df, "pathology", lambda x: x.replace("<st0>", "").replace("</st0>", "")
         .replace("<st>", "").replace("</st>", ""))
    _map(df, "impression", lambda x: x.replace("*", " "))
    df.set_column("report_preprocessed", [remove_extra_spaces(x) for x in df.column("report")])
    for broken, fixed in _BROKEN_FINALIZED:
        _str_replace(df, "report_preprocessed", broken, fixed)
    _map(df, "report_preprocessed", extract_report)
    _str_replace(df, "report_preprocessed", _TIMESTAMP_RE, "")
    for col in ("report_preprocessed", "pathology"):
        _str_replace(df, col, _PATHOLOGY_REF_RE, "")
    _map(df, "report_preprocessed", roman_to_int)

    reports = df.column("report")
    df.set_column("malignancy_benign_section_nl",
                  [_section(r, ["maligniteit", "benigne"]) for r in reports])
    df.set_column("birads_section_nl",
                  [_section(r, ["BI-RADS", "BIRADS", "BIRAD"], roman=True) for r in reports])
    df.set_column("conclusion_nl", [_section(r, ["Conclusie"]) for r in reports])

    for column in ("report_preprocessed", "pathology", "impression",
                   "malignancy_benign_section_nl", "birads_section_nl", "conclusion_nl"):
        for keyword in _KEYWORDS_TO_REMOVE:
            _str_replace(df, column, keyword, "")
        for keyword in _KEYWORDS_TO_REPLACE:
            _str_replace(df, column, keyword, " ")

    _map(df, "report_preprocessed", lambda x: x.lstrip())
    _map(df, "report_preprocessed", lambda x: x.replace(". ", "", 1) if x.startswith(".") else x)
    _map(df, "malignancy_benign_section_nl", lambda x: x.lstrip())
    _map(df, "birads_section_nl", lambda x: x.lstrip())

    df.set_column("labels", [translate_labels(extract_labels(r["birads_section_nl"], r["is_malig"],
                                                             r["report"])) for r in df.rows])
    for row in df.rows:
        _validate_report(row)
    _map(df, "report_preprocessed", lambda x: remove_extra_spaces(x) if isinstance(x, str) else x)

    df.set_column("has_report_current", ["Report current " in x for x in reports])
    df.set_column("has_report_US", ["Report US " in x for x in reports])
    df.set_column("has_report_MG", ["Report MG " in x for x in reports])
    df.set_column("has_report_MR", ["Report MR " in x for x in reports])
    df.set_column("has_report_others",
                  [any(t in x for t in ["OTUS", "MROT", "MGOT"]) for x in reports])

    # stable, missing exam dates last
    order = sorted(range(len(df)), key=lambda i: (
        df.rows[i]["patient_id"], df.rows[i]["exam_date"] is None, df.rows[i]["exam_date"] or ""))
    df = Table(df.columns, [df.rows[i] for i in order])

    if export:
        export_dir = os.path.join(os.getcwd(), "data", time.strftime("%Y-%m-%d/%H-%M-%S", time.gmtime()))
        create_directory_if_not_exists(export_dir)
        write_csv(os.path.join(export_dir, "processed_reports.csv"), df, encoding="latin1")
        append_text_column(os.path.join(export_dir, "nl_reports_only.txt"), df.column("report"))
    return df


def post_process_translated_report(df: Union[Table, List[Dict]], config, export: bool = False,
                                   export_dir: Optional[str] = None) -> Table:
    """Post-Google-translate cleanup (reference: data_utils.py:815-878)."""
    df = _as_table(df)
    df = df.rename({df.columns[-2]: "image_impression", df.columns[-1]: "image_description"})

    # a missing id formats as pandas' NaN does
    _map(df, "patient_id", lambda x: "{0:0>8}".format(float("nan") if x is None else x))
    base = config.dataset.config.base_dataset_path
    df.set_column("study_path", [os.path.join(base, r["patient_id"][0:2], r["patient_id"], r["study_id"])
                                 for r in df.rows])
    _map(df, "image_description", lambda x: re.sub(r"[^\x00-\x7F]+", "", x))
    _map(df, "image_description", remove_duplicate_sentences)
    df = df.select(x != "#VALUE!" for x in df.column("image_description"))
    _map(df, "image_description", lambda x: x.replace("malignancy", "malignant"))
    _map(df, "image_description", lambda x: x.replace("BI-RADS", "BIRADS"))
    _map(df, "image_description", lambda x: x.replace(":", " ").replace(",", " ").replace("-", " ")
         .replace('""', "").replace("...", ""))

    if export:
        export_dir = os.path.join(os.getcwd(), export_dir)
        create_directory_if_not_exists(export_dir)
        write_csv(os.path.join(export_dir, "postprocessed_tr_dataset.csv"), df)
        append_text_column(os.path.join(export_dir, "en_reports_only.txt"), df.column("image_description"))
        append_text_column(os.path.join(export_dir, "en_impression_only.txt"),
                           df.column("image_impression"))
    return df


def map_path_to_features(df: Union[Table, List[Dict]], config, export: bool = False,
                         export_dir: Optional[str] = None) -> Table:
    """Point study paths at the extracted feature store
    (reference: data_utils.py:880-919).  Accepts .npy or .pth stores."""

    def patient_id_of(path):
        match = re.search(r"\d{8}", path)
        return match.group() if match else None

    def modify(study_path):
        tail = study_path.split("2D_100micron/")[-1]
        base = os.path.join(config.base.features_export_dir, tail, str(patient_id_of(study_path)))
        for suffix in (".npy", ".pth"):
            if os.path.isfile(base + suffix):
                return base + suffix
        return base + ".npy"

    df = _as_table(df)
    _map(df, "study_path", modify)
    df = df.select(os.path.isfile(p) for p in df.column("study_path")).reset_index()

    if export:
        export_dir = os.path.join(os.getcwd(), export_dir)
        create_directory_if_not_exists(export_dir)
        write_csv(os.path.join(export_dir, "final_reports_dataset.csv"), df, encoding="latin1")
    return df
