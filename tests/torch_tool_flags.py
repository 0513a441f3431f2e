"""The flags of a JAX tool (``tools/{tool}.py``), read from the parser its
``main`` builds, for the port's tools to be held against."""

import argparse
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Parsed(Exception):
    pass


def jax_parser(tool: str) -> argparse.ArgumentParser:
    """The parser ``tools/{tool}.py``'s main builds, caught at its parse."""
    spec = importlib.util.spec_from_file_location(f"jax_{tool}", os.path.join(REPO, "tools", f"{tool}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def parse_args(self, *a, **k):
        raise _Parsed(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed) as e:
            mod.main()
    return e.value.args[0]


def defaults(parser) -> dict:
    """{dest: (default, nargs, action)} of every flag but ``--help``."""
    return {a.dest: (a.default, a.nargs, type(a).__name__) for a in parser._actions if a.dest != "help"}
