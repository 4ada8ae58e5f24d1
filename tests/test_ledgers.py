"""Ledger fences: the documents a reader takes numbers from.

- No document cites a record that is not in the repository (the old
  ``BENCH_r*`` / ``MULTICHIP_r*`` records, ``BASELINE.md``,
  ``benchmarks/ROOFLINE.md``, ``VERDICT.md`` and ``ADVICE.md`` were deleted
  with the port to the GPU; a citation of one would be a number nobody can
  check).
- The suite and test counts the ledgers quote equal the live collection.
"""

from __future__ import annotations

import glob
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every ledger a reader would take numbers from.
DOCS = [
    "README.md",
    "PARITY.md",
    "ROADMAP.md",
    "QUIRKS.md",
    "DESIGN.md",
    "MIGRATION.md",
    "PERF.md",
    ".claude/skills/verify/SKILL.md",
]

_DELETED_RECORDS = re.compile(
    r"BENCH_r\d+|MULTICHIP_r\d+|BASELINE\.(?:md|json)|ROOFLINE\.md"
    r"|VERDICT\.md|ADVICE\.md|benchmarks/runs/"
)


@pytest.mark.parametrize("rel", DOCS)
def test_ledger_cites_no_deleted_record(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        text = f.read()
    hits = sorted(set(m.group(0) for m in _DELETED_RECORDS.finditer(text)))
    assert not hits, f"{rel} cites records that are not in the repo: {hits}"


def test_deleted_records_stay_deleted():
    """The fence above is only meaningful while the records are gone."""
    for pattern in ("BENCH_r*.json", "MULTICHIP_r*.json", "BASELINE.*",
                    "VERDICT.md", "ADVICE.md", "benchmarks/ROOFLINE.md",
                    "benchmarks/runs/*.json"):
        assert not glob.glob(os.path.join(ROOT, pattern)), pattern


def test_suite_counts_in_ledgers_match_reality():
    """PARITY/ROADMAP/MIGRATION quote suite/test counts; they must equal
    the live collection (the 'keep the ledgers exact' discipline,
    mechanized).  Collection runs in a subprocess so this test sees the
    same set the user's `pytest tests/` would."""
    import re
    import subprocess
    import sys

    n_suites = len(glob.glob(os.path.join(ROOT, "tests", "test_*.py")))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q",
         "-p", "no:cacheprovider"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    # A partial collection failure still prints a (reduced) "N tests
    # collected, 1 error" line — distinguish a broken environment from
    # genuine ledger drift before comparing any counts.
    assert proc.returncode == 0, (
        f"collection itself failed (rc={proc.returncode}):\n"
        + proc.stdout[-2000:] + proc.stderr[-500:]
    )
    m = re.search(r"(\d+) tests collected", proc.stdout)
    assert m, proc.stdout[-2000:]
    n_tests = int(m.group(1))

    checks = [
        ("PARITY.md", rf"\({n_suites} suites, {n_tests} tests\)"),
        ("ROADMAP.md", rf"tests \({n_tests} passing\)"),
        ("MIGRATION.md", rf"{n_tests} tests / {n_suites} suites"),
    ]
    for rel, pattern in checks:
        with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
            text = f.read()
        assert re.search(pattern, text), (
            f"{rel} does not carry the live counts "
            f"({n_suites} suites / {n_tests} tests): update the ledger"
        )
