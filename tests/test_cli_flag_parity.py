"""
Mechanical CLI flag-parity against the reference argparse surface.

The drop-in contract is the reference's FULL parser tree (cli.py:110-1186,
gen/cli.py:92-536), not a spot-checked subset: a renamed default or a
missing rare flag would otherwise hide indefinitely. This test imports the
reference's `parse_arguments` in a subprocess (its `analyse`/`gen` packages
would shadow our drop-in shims in-process), serialises both parser trees,
and asserts that every reference subcommand / option string / default /
choice set / type exists with equal semantics in ours. Extras on our side
(e.g. --json, --timing, engine flags) are allowed.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest

REFERENCE_ROOT = "/root/reference"

# Serialise an argparse parser (and one level of subparsers) to plain data.
# Shared by the subprocess (reference side) and the in-process (ours) side —
# keep it dependency-free and self-contained.
_DUMP_HELPERS = '''
import argparse, json

def _default_repr(action):
    d = action.default
    if d is None or isinstance(d, (bool, int, str)):
        return d
    if isinstance(d, float):
        return float(d)
    return repr(d)

def _action_kind(action):
    name = type(action).__name__
    if name == "BooleanOptionalAction":
        return "store_true" if not action.default else "store_false"
    return {
        "_StoreTrueAction": "store_true",
        "_StoreFalseAction": "store_false",
        "_StoreConstAction": "store_const",
        "_StoreAction": "store",
        "_HelpAction": "help",
        "_AppendAction": "append",
        "_CountAction": "count",
    }.get(name, name)

def dump_parser(parser):
    flags = {}
    subcommands = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for sub_name, sub_parser in action.choices.items():
                subcommands[sub_name] = dump_parser(sub_parser)
            continue
        if not action.option_strings:
            continue  # positional
        for opt in action.option_strings:
            if opt in ("-h", "--help"):
                continue
            flags[opt] = {
                "dest": action.dest,
                "default": _default_repr(action),
                "type": getattr(action.type, "__name__", None)
                if action.type is not None
                else None,
                "choices": sorted(action.choices) if action.choices else None,
                "kind": _action_kind(action),
                "required": bool(action.required),
            }
    return {"flags": flags, "subcommands": subcommands}
'''

_REFERENCE_DUMP_SCRIPT = (
    _DUMP_HELPERS
    + '''
import sys
# parse_arguments() ends in parser.parse_args(); intercept to get the parser
argparse.ArgumentParser.parse_args = lambda self, *a, **k: self
import importlib
mod = importlib.import_module(sys.argv[1])
parser = mod.parse_arguments()
print(json.dumps(dump_parser(parser)))
'''
)


def _reference_parser_dump(module: str) -> dict:
    if not os.path.exists(os.path.join(REFERENCE_ROOT, module.split(".")[0], "__init__.py")):
        pytest.skip("reference tree not mounted")
    env = dict(os.environ)
    # matplotlib in the reference must not try to open a display / write
    # caches anywhere odd
    env["MPLBACKEND"] = "Agg"
    # the reference tree ONLY — our repo's analyse/gen shims must not shadow
    env["PYTHONPATH"] = REFERENCE_ROOT
    env["PYTHONDONTWRITEBYTECODE"] = "1"  # never touch the read-only mount
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_DUMP_SCRIPT, module],
        capture_output=True,
        text=True,
        timeout=300,
        cwd=REFERENCE_ROOT,
        env=env,
    )
    assert run.returncode == 0, f"reference dump failed:\n{run.stderr[-2000:]}"
    return json.loads(run.stdout.strip().splitlines()[-1])


def _our_parser_dump(build_parser) -> dict:
    namespace: dict = {}
    exec(compile(_DUMP_HELPERS, "<dump_helpers>", "exec"), namespace)
    return namespace["dump_parser"](build_parser())


@pytest.fixture(scope="module")
def analyse_dumps():
    from audio_analysis_tpu.cli.analyse_cli import build_parser

    return _reference_parser_dump("analyse.cli"), _our_parser_dump(build_parser)


@pytest.fixture(scope="module")
def gen_dumps():
    from audio_analysis_tpu.cli.gen_cli import build_parser

    return _reference_parser_dump("gen.cli"), _our_parser_dump(build_parser)


def _defaults_equal(ref, ours) -> bool:
    if isinstance(ref, float) and isinstance(ours, (int, float)):
        if math.isnan(ref):
            return isinstance(ours, float) and math.isnan(ours)
        return math.isclose(float(ref), float(ours), rel_tol=0.0, abs_tol=0.0)
    return ref == ours


def _assert_flag_parity(sub_name: str, opt: str, ref_spec: dict, our_spec: dict):
    where = f"{sub_name or '<top>'} {opt}"
    assert _defaults_equal(ref_spec["default"], our_spec["default"]), (
        f"{where}: default {our_spec['default']!r} != reference "
        f"{ref_spec['default']!r}"
    )
    if ref_spec["choices"] is not None:
        assert our_spec["choices"] is not None and set(ref_spec["choices"]) <= set(
            our_spec["choices"]
        ), f"{where}: choices {our_spec['choices']} missing {ref_spec['choices']}"
    if ref_spec["type"] is not None:
        assert our_spec["type"] == ref_spec["type"], (
            f"{where}: type {our_spec['type']} != reference {ref_spec['type']}"
        )
    # a store_true in the reference may be a BooleanOptionalAction here (the
    # dump normalises that to store_true); the flag kind must agree so
    # presence/absence semantics match
    assert our_spec["kind"] == ref_spec["kind"], (
        f"{where}: action kind {our_spec['kind']} != reference {ref_spec['kind']}"
    )
    assert our_spec["required"] == ref_spec["required"], (
        f"{where}: required={our_spec['required']} != reference "
        f"{ref_spec['required']}"
    )


def _assert_tree_parity(ref: dict, ours: dict, label: str):
    missing_subs = set(ref["subcommands"]) - set(ours["subcommands"])
    assert not missing_subs, f"{label}: missing subcommands {sorted(missing_subs)}"

    for opt, ref_spec in ref["flags"].items():
        assert opt in ours["flags"], f"{label} <top>: missing flag {opt}"
        _assert_flag_parity("<top>", opt, ref_spec, ours["flags"][opt])

    for sub_name, ref_sub in ref["subcommands"].items():
        our_sub = ours["subcommands"][sub_name]
        for opt, ref_spec in ref_sub["flags"].items():
            assert opt in our_sub["flags"], f"{label} {sub_name}: missing flag {opt}"
            _assert_flag_parity(sub_name, opt, ref_spec, our_sub["flags"][opt])


def test_reference_surface_is_complete(analyse_dumps, gen_dumps):
    """Guard the guard: the reference dump really contains the full surface
    (14 analyse subcommands, 11 gen subcommands) — an import regression in
    the dump harness must not silently pass an empty tree."""
    ref_analyse, _ = analyse_dumps
    ref_gen, _ = gen_dumps
    # ir zplane groupdelay bundle deconvolve decay rt60bands fr filter
    # spectrogram diffusion waterfall modalcloud report (cli.py:125-1151)
    assert len(ref_analyse["subcommands"]) == 14
    assert len(ref_gen["subcommands"]) == 11  # 10 generators + all


def test_analyse_cli_flag_parity(analyse_dumps):
    ref, ours = analyse_dumps
    _assert_tree_parity(ref, ours, "analyse")


def test_gen_cli_flag_parity(gen_dumps):
    ref, ours = gen_dumps
    _assert_tree_parity(ref, ours, "gen")
