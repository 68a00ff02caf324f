"""The port's facade surface against the reference's committed snapshot.

Every line ``python -m repro_torch.db.surface`` prints must equal the
reference's ``docs/api_surface.txt`` line for the same name (``repro.``
read as ``repro_torch.``), or be a known difference below; every
reference name the port lacks must be known too.  Each known difference
names the ROADMAP queue 1 item that closes it (by its bold title), or
says why it stays.  An entry that no longer differs fails the test, so
the list stays true as items land.
"""
from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEEP = "kept: every entry point of the port takes device="

# port lines that differ from the reference's line of the same name
DIFFERS = {
    "create": KEEP,
    "open": KEEP,
}
# reference names the port does not print
MISSING: dict = {}

def _by_name(text: str) -> dict[str, str]:
    return {re.split(r"[( ]", line, maxsplit=1)[0]: line
            for line in text.splitlines() if line}


def test_port_surface_matches_reference_snapshot():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    printed = subprocess.run(
        [sys.executable, "-m", "repro_torch.db.surface"], env=env,
        capture_output=True, text=True, check=True, timeout=300).stdout
    port = _by_name(printed)
    ref = _by_name((ROOT / "docs" / "api_surface.txt").read_text()
                   .replace("repro.", "repro_torch."))
    assert len(port) == len(printed.splitlines())
    for name, line in port.items():
        if name in DIFFERS:
            assert name in ref and line != ref[name], (
                f"{name} no longer differs: drop it from DIFFERS")
        else:
            assert line == ref.get(name), (name, line, ref.get(name))
    lacking = set(ref) - set(port)
    assert lacking == set(MISSING), (lacking ^ set(MISSING))
    for name in ("Database.serve", "Database.attach_maintainer",
                 "Database.ingest_queue", "IndexSpec", "IngestSpec",
                 "IngestSpec.from_dict", "IngestSpec.to_dict"):
        assert port[name] == ref[name]


def test_known_differences_name_roadmap_items():
    titles = set(re.findall(r"^\d+\. \*\*(.+?)\.\*\*",
                            (ROOT / "ROADMAP.md").read_text(), re.M))
    for tag in {**DIFFERS, **MISSING}.values():
        if tag == KEEP:
            continue
        for item in tag.split("; "):
            assert item in titles, (item, titles)
