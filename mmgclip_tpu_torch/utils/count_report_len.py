"""Report-length statistics tool (port of mmgclip_tpu/utils/count_report_len.py;
reference: mmgclip/utils/count_report_len.py:1-37).

    python -m mmgclip_tpu_torch.utils.count_report_len --file_path image_description.txt

Reads the ``image_description.txt`` a dataset writes (one report per line,
CSV-quoted where needed) and prints word and sentence counts.
"""

from __future__ import annotations

import argparse
from typing import Iterable, List, Optional, Tuple

import numpy as np

from .table import Table


def report_length_stats(lines: Iterable[str]) -> Tuple[List[int], List[int]]:
    word_counts = []
    sentence_counts = []
    for line in lines:
        line = line.rstrip()
        if len(line) >= 2 and line[0] == line[-1] == '"':
            line = line[1:-1]  # strip wrapping quotes from the csv export
        word_counts.append(len(line.split()))
        sentence_counts.append(line.count("."))
    return word_counts, sentence_counts


def tables(word_counts: List[int], sentence_counts: List[int]) -> Tuple[Table, Table]:
    general = Table(["General"])
    general.add_row([f"Total number of reports is {len(word_counts)}"])
    general.add_row([f"Total number of unique report lengths is {len(np.unique(word_counts))}"])
    general.add_row([
        f"Average count of words in all reports is {round(np.mean(word_counts), 3)}, "
        f"STD is {round(np.std(word_counts), 3)}"])

    results = Table(["Description", "Value", "Index"])
    for label, counts, pick in (("Minimum count of words in one report", word_counts, min),
                                ("Maximum count of words in one report", word_counts, max),
                                ("Minimum count of sentences in one report", sentence_counts, min),
                                ("Maximum count of sentences in one report", sentence_counts, max)):
        value = pick(counts)
        results.add_row([label, value, counts.index(value) + 1])
    return general, results


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--file_path", type=str, required=True, help="Path to the text file.")
    args = parser.parse_args(argv)
    if not args.file_path.endswith(".txt"):
        raise ValueError("File path should be a path of a text `.txt` file.")

    with open(args.file_path) as fh:
        word_counts, sentence_counts = report_length_stats(fh)
    general, results = tables(word_counts, sentence_counts)
    print(general)
    print(results)


if __name__ == "__main__":
    main()
