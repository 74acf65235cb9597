"""Every flag of the JAX package's parser in the port's.

For each flag of ``byol_tpu.cli.build_parser()`` one argv sets it away
from its default (a non-default choice, a shifted number, a string, the
switch thrown) and both packages' ``config_from_args`` must give the same
``Config``, field for field, or the port must refuse it with a message
naming ROADMAP.md.  The defaults, choices and types agree flag for flag,
``--fsdp`` against an explicit ``--zero1 off`` exits with JAX's message,
and the visdom flags parse, warn and fall back to ``--grapher``.
"""
import argparse

import pytest

from byol_tpu.cli import build_parser as jax_parser
from byol_tpu.cli import config_from_args as jax_config_from_args
from byol_tpu_torch import cli as torch_cli

# values where a generic one would not parse or mean the flag
VALUES = {"--arch": "resnet18", "--task": "fake",
          "--weight-initialization": "orthogonal",
          "--distributed-master": "10.0.0.1:1234",
          "--optimizer": "lars_adam", "--data-dir": "/data/x",
          "--log-dir": "/logs/x", "--model-dir": "/models/x",
          "--uid": "exp", "--zero1": "on"}
# the port parses these and refuses them when they are set, naming
# ROADMAP.md (no Config field carries them)
REFUSED_AT_RUN = {"--profile-port"}
ONE_REPLICA = ["--num-replicas", "1"]


def _actions():
    return [a for a in jax_parser()._actions
            if a.option_strings and a.dest != "help"]


def _flag_argv(action):
    """One argv that moves ``action`` away from its default."""
    flag = action.option_strings[0]
    if isinstance(action, argparse.BooleanOptionalAction):
        return [flag if not action.default else "--no-" + flag[2:]]
    if isinstance(action, (argparse._StoreTrueAction,
                           argparse._StoreFalseAction)):
        return [flag]
    if flag in VALUES:
        return [flag, VALUES[flag]]
    if action.choices:
        return [flag, next(c for c in action.choices
                           if c != action.default)]
    if action.type is int:
        return [flag, str((action.default or 0) + 3)]
    if action.type is float:
        return [flag, str((action.default or 0.0) + 0.25)]
    return [flag, "value"]


FLAGS = {a.option_strings[0]: a for a in _actions()}


def test_the_port_has_every_flag_with_its_default_choices_and_type():
    ours = {o: a for a in torch_cli.build_parser()._actions
            for o in a.option_strings}
    theirs = {o: a for a in jax_parser()._actions for o in a.option_strings}
    assert set(ours) == set(theirs)
    for opt, action in theirs.items():
        mine = ours[opt]
        assert (mine.dest, mine.default, mine.choices, mine.type,
                mine.nargs, type(mine)) == (
            action.dest, action.default, action.choices, action.type,
            action.nargs, type(action)), opt


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_flag_gives_the_same_config(flag):
    argv = _flag_argv(FLAGS[flag])
    if flag != "--num-replicas":
        argv = argv + ONE_REPLICA
    theirs = jax_config_from_args(jax_parser().parse_args(argv))
    ours = torch_cli.config_from_args(
        torch_cli.build_parser().parse_args(argv))
    assert ours.to_dict() == theirs.to_dict()
    default = torch_cli.config_from_args(
        torch_cli.build_parser().parse_args(ONE_REPLICA))
    moved = ours.to_dict() != default.to_dict()
    no_field = {"--no-cuda", "--num-processes", "--linear-eval",
                "--visdom-url", "--visdom-port", "--profile-port",
                "--half"}
    # a flag either moves a Config field, or has none to move
    assert moved != (flag in no_field), (flag, moved)


@pytest.mark.parametrize("flag", sorted(REFUSED_AT_RUN))
def test_flag_without_a_port_path_is_refused_naming_roadmap(flag, capsys):
    argv = ["--no-cuda"] + _flag_argv(FLAGS[flag])
    assert torch_cli.main(argv) == 2
    assert "ROADMAP.md" in capsys.readouterr().err


def test_fsdp_is_zero1_on_and_conflicts_with_an_explicit_off():
    for argv in (["--fsdp"], ["--fsdp", "--zero1", "on"]):
        ours = torch_cli.config_from_args(
            torch_cli.build_parser().parse_args(argv + ONE_REPLICA))
        assert ours.device.zero1 == "on"
    argv = ["--fsdp", "--zero1", "off"] + ONE_REPLICA
    with pytest.raises(SystemExit) as ours:
        torch_cli.config_from_args(torch_cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as theirs:
        jax_config_from_args(jax_parser().parse_args(argv))
    assert str(ours.value) == str(theirs.value)
    assert "--fsdp" in str(ours.value)


def test_visdom_flags_warn_and_fall_back(capsys):
    """``--visdom-url`` warns, names the grapher it falls back to, and
    the run goes on (here: to the refusal of --profile-port, which stops
    it before anything is built)."""
    rc = torch_cli.main(["--no-cuda", "--visdom-url", "http://v",
                         "--visdom-port", "8097", "--grapher", "jsonl",
                         "--profile-port", "9"])
    err = capsys.readouterr().err
    assert rc == 2
    assert "visdom" in err and "--grapher=jsonl" in err
