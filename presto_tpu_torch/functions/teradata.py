"""Teradata compatibility functions of the PyTorch port
(``presto_tpu/functions/teradata.py``).

A VARCHAR column is dictionary codes, so a string function runs once per
distinct value, on the host, over the column's dictionary: a string ->
number function becomes a lookup table gathered by code on the device, and
a string -> string function a re-encoded dictionary plus a code remap
(deduplicated, since two values may map to one), as the port's
``length``/``upper``/``lower`` do.

Provided: ``index(string, substring)`` (1-based, 0 when absent) and its
ANSI twin ``strpos``, ``char2hexint(string)`` (UTF-16-BE code units as
4-digit hex groups), ``reverse``, ``trim``/``ltrim``/``rtrim``, and
``char_length``/``character_length`` (aliases of ``length``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..block import Dictionary
from ..ops.expressions import Call, Constant, _DeviceTable, register_compiler
from ..sql.analyzer import SemanticError, register_scalar_function
from ..types import BIGINT, VARCHAR, is_string


def _materialized(compiler, expr):
    """(fn, dictionary) of the string argument; a virtual dictionary (no
    values) is refused, as in the reference."""
    f, d = compiler._compile(expr.args[0])
    if d is None or not hasattr(d, "values"):
        raise NotImplementedError(f"{expr.name}() needs a materialized dictionary column")
    return f, d


def _gather(f, table: _DeviceTable, hi: int):
    def fn(datas, nulls):
        c, n = f(datas, nulls)
        return table.on(c.device)[c.to(torch.int64).clamp(0, hi)], n
    return fn


def _dict_scalar_compiler(value_fn, out_dtype):
    """string -> number: evaluated per dictionary entry on the host, then
    gathered by code on the device."""
    def compile_(compiler, expr):
        f, d = _materialized(compiler, expr)
        extra = tuple(a.value for a in expr.args[1:])
        table = _DeviceTable(np.asarray([value_fn(str(v), *extra) for v in d.values],
                                        dtype=out_dtype))
        return _gather(f, table, max(len(d.values) - 1, 0)), None
    return compile_


def _dict_string_compiler(value_fn):
    """string -> string: the transformed values re-encoded into a
    deduplicated sorted dictionary, the codes remapped on the device."""
    def compile_(compiler, expr):
        f, d = _materialized(compiler, expr)
        transformed = [value_fn(str(v)) for v in d.values]
        new_dict = Dictionary(sorted(set(transformed)))
        pos = new_dict.index()
        table = _DeviceTable(np.asarray([pos[v] for v in transformed], dtype=np.int32))
        return _gather(f, table, max(len(transformed) - 1, 0)), new_dict
    return compile_


def _string_arg_typer(out_type, n_const_args: int = 0, name_override=None):
    def typer(name, args):
        if len(args) != 1 + n_const_args:
            raise SemanticError(f"{name}() takes {1 + n_const_args} argument(s), "
                                f"got {len(args)}")
        if not is_string(args[0].type):
            raise SemanticError(f"{name}() expects a varchar argument")
        for a in args[1:]:
            if not isinstance(a, Constant):
                raise SemanticError(f"{name}() extra arguments must be literals "
                                    f"(evaluated per distinct dictionary value)")
        return Call(out_type, name_override or name, tuple(args))
    return typer


def _index(s: str, sub) -> int:
    return s.find(str(sub)) + 1  # 1-based; 0 = absent (Teradata INDEX)


def _char2hexint(s: str) -> str:
    # UTF-16-BE code units, 4 hex digits each (an astral character gives
    # its surrogate pair)
    return s.encode("utf-16-be").hex().upper()


def _t_char_length(name, args):
    if len(args) != 1 or not is_string(args[0].type):
        raise SemanticError(f"{name}() expects one varchar argument")
    return Call(BIGINT, "length", tuple(args))


register_scalar_function("index", _string_arg_typer(BIGINT, 1))
register_scalar_function("strpos", _string_arg_typer(BIGINT, 1, name_override="index"))
register_scalar_function("char2hexint", _string_arg_typer(VARCHAR))
register_scalar_function("reverse", _string_arg_typer(VARCHAR))
register_scalar_function("trim", _string_arg_typer(VARCHAR))
register_scalar_function("ltrim", _string_arg_typer(VARCHAR))
register_scalar_function("rtrim", _string_arg_typer(VARCHAR))
register_scalar_function("char_length", _t_char_length)
register_scalar_function("character_length", _t_char_length)

register_compiler("index", _dict_scalar_compiler(_index, np.int64))
register_compiler("char2hexint", _dict_string_compiler(_char2hexint))
register_compiler("reverse", _dict_string_compiler(lambda s: s[::-1]))
register_compiler("trim", _dict_string_compiler(str.strip))
register_compiler("ltrim", _dict_string_compiler(str.lstrip))
register_compiler("rtrim", _dict_string_compiler(str.rstrip))
