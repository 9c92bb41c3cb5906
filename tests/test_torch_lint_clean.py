"""The port's own lint gate: ``pio_tpu_torch`` and the port's tests pass
the port's linter (``python -m pio_tpu_torch lint``) clean, with the
reference's interprocedural rules registered. Every rule ships with the
port already conforming, so a finding here is a regression in the change
under test (or a rule fault; either way it blocks).

Also pinned: the port's payload builders carry the producer markers the
reference's do (``# pio: endpoint=``), so every endpoint the reference
produces has a producer in the port and the contract rules check the
port's consumers against it; and the verb's exit codes and flags.
"""

from __future__ import annotations

import json
import os

from pio_tpu.analysis.contracts import contracts_inventory as r_inventory
from pio_tpu.analysis.core import LintContext as RLintContext
from pio_tpu.analysis.core import collect_files as r_collect
from pio_tpu.analysis.core import parse_module as r_parse
from pio_tpu_torch.analysis import all_rules, run_lint
from pio_tpu_torch.analysis.contracts import contracts_inventory
from pio_tpu_torch.analysis.core import (
    LintContext, collect_files, default_paths, parse_module,
)
from pio_tpu_torch.tools import cli
from pio_tpu_torch.utils import knobs

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_interprocedural_rules_registered():
    rules = all_rules()
    for rid in ("hotpath-blocking", "hotpath-zero-copy",
                "shm-frame-layout", "lock-blocking-call"):
        assert rid in rules, f"rule {rid} missing from registry"


def test_port_is_lint_clean():
    paths = default_paths()
    assert os.path.join(REPO_ROOT, "pio_tpu_torch") in paths
    assert os.path.join(REPO_ROOT, "tests", "test_torch_lint_clean.py") \
        in paths
    assert not any(os.path.basename(p) == "test_lint_clean.py"
                   for p in paths)
    findings = run_lint(paths)
    assert findings == [], "pio_tpu_torch lint findings:\n" + "\n".join(
        f.render() for f in findings
    )


def test_every_reference_endpoint_has_a_port_producer():
    """A payload builder without its marker is invisible to the contract
    rules: its consumers (the fleet aggregator, the dashboard, the tests)
    went unchecked. The port's producers cover the reference's."""
    port = contracts_inventory(
        [parse_module(p) for p in collect_files(
            [os.path.join(REPO_ROOT, "pio_tpu_torch")])], LintContext())
    ref = r_inventory(
        [r_parse(p) for p in r_collect(
            [os.path.join(REPO_ROOT, "pio_tpu")])], RLintContext())

    def produced(inv):
        return {ep for ep, v in inv["endpoints"].items() if v["producers"]}

    assert produced(port) == produced(ref)
    for ep in ("/device.json", "/train.json", "/stats.json",
               "/storage.json", "/debug/hotpath.json", "/qos.json"):
        assert port["endpoints"][ep]["consumers"], ep


def test_knob_table_is_generated_from_the_registry():
    with open(os.path.join(REPO_ROOT, "pio_tpu_torch", "KNOBS.md"),
              encoding="utf-8") as f:
        assert knobs.markdown_table() in f.read()
    for name in ("PIO_TPU_HOME", "PIO_TPU_DEBUG_SYNC",
                 "PIO_TPU_PARTLOG_PARTITIONS", "PIO_TPU_REPL_MIN_ACKS"):
        assert name in knobs.KNOBS


def test_lint_verb_exit_codes_and_flags(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import time\n\n\ndef f():\n    return time.time()\n")
    good = tmp_path / "good.py"
    good.write_text("def f():\n    return 1\n")
    assert cli.main(["lint", str(good)]) == 0
    assert "clean" in capsys.readouterr().out
    assert cli.main(["lint", "--json", str(bad)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in out["findings"]] == ["wallclock-duration"]
    assert cli.main(["lint", "--rules", "no-such-rule", str(good)]) == 2
    capsys.readouterr()
    assert cli.main(["lint", "--list-rules"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(all_rules())
    assert cli.main(["lint", "--dump-failpoints", str(bad)]) == 0
    assert json.loads(capsys.readouterr().out) == {"failpoints": []}
