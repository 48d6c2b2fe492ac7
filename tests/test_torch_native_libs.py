"""tests/jax_native_libs.py rebuilds the JAX package's C++ libraries with
the JAX loaders' own g++ commands: each copy is held to its loader's source,
so a change there fails here instead of building a different library."""

import ast
import importlib
import inspect

import pytest

import jax_native_libs


def _gxx_command(module):
    """The list literal that starts with "g++" in ``module``'s source, with
    names kept as their identifiers."""
    tree = ast.parse(inspect.getsource(module))
    (cmd,) = [n for n in ast.walk(tree) if isinstance(n, ast.List) and n.elts
              and isinstance(n.elts[0], ast.Constant) and n.elts[0].value == "g++"]
    return [e.value if isinstance(e, ast.Constant) else e.id for e in cmd.elts]


@pytest.mark.parametrize("name", sorted(jax_native_libs.COMMANDS))
def test_rebuild_command_is_the_jax_loaders(name):
    assert jax_native_libs.COMMANDS[name] == _gxx_command(importlib.import_module(name))
