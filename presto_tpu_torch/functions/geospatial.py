"""Geospatial functions of the PyTorch port (``presto_tpu/functions/geospatial.py``).

- A POINT is one complex128 value (x + iy), the port's ``GEOMETRY`` column
  dtype: ``st_point``, ``st_x``, ``st_y`` and ``st_distance`` are complex
  arithmetic on tensors.
- A POLYGON exists only as a plan-time constant: ``st_geometryfromtext``
  over a literal parses the WKT during analysis. ``st_contains`` and
  ``st_within`` against that constant compile to a crossing-number test over
  the point column, unrolled over the ring's edges; ``st_area`` folds to a
  DOUBLE literal (shoelace).
- ``great_circle_distance(lat1, lon1, lat2, lon2)`` is the haversine
  distance in km.

A per-row polygon is refused at analysis, as in the reference.
"""
from __future__ import annotations

import re
from typing import List, Tuple

import torch

from ..ops.expressions import Call, Constant, register_compiler
from ..sql.analyzer import SemanticError, cast_to, register_scalar_function
from ..types import BOOLEAN, DOUBLE, GEOMETRY

_NUM = r"[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?"


def parse_wkt(text: str):
    """'POINT (x y)' -> complex; 'POLYGON ((x y, ...))' -> a ring tuple."""
    s = text.strip()
    m = re.fullmatch(rf"POINT\s*\(\s*({_NUM})\s+({_NUM})\s*\)", s, re.IGNORECASE)
    if m:
        return complex(float(m.group(1)), float(m.group(2)))
    m = re.fullmatch(r"POLYGON\s*\(\((.*)\)\)", s, re.IGNORECASE | re.DOTALL)
    if m:
        pts: List[Tuple[float, float]] = []
        for pair in m.group(1).split(","):
            xy = pair.split()
            if len(xy) != 2 or not all(re.fullmatch(_NUM, v) for v in xy):
                raise SemanticError(f"malformed WKT polygon vertex {pair!r}")
            pts.append((float(xy[0]), float(xy[1])))
        if len(pts) >= 2 and pts[0] == pts[-1]:
            pts.pop()  # the closing vertex: the test wraps around anyway
        if len(pts) < 3:
            raise SemanticError("WKT polygon needs at least 3 vertices")
        return tuple(pts)
    raise SemanticError(f"unsupported WKT {text[:40]!r} (POINT and single-ring POLYGON)")


def _const_geometry(arg):
    if isinstance(arg, Constant) and isinstance(arg.value, (tuple, complex)):
        return arg.value
    raise SemanticError(
        "this geometry argument must be a constant (ST_GeometryFromText over a "
        "literal): per-row polygons have no device representation")


def _shoelace(ring) -> float:
    area = 0.0
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        area += x1 * y2 - x2 * y1
    return abs(area) / 2.0


def _or_nulls(a, b):
    return a if b is None else (b if a is None else a | b)


# --- typers (analysis) -----------------------------------------------------

def _t_st_point(name, args):
    if len(args) != 2:
        raise SemanticError("st_point(x, y) takes two arguments")
    return Call(GEOMETRY, "st_point", tuple(cast_to(a, DOUBLE) for a in args))


def _t_st_geometryfromtext(name, args):
    if len(args) != 1:
        raise SemanticError("st_geometryfromtext(wkt) takes one argument")
    if not isinstance(args[0], Constant):
        raise SemanticError("st_geometryfromtext requires a literal WKT string")
    return Constant(GEOMETRY, parse_wkt(str(args[0].value)))


def _t_coord(name, args):
    if len(args) != 1 or args[0].type is not GEOMETRY:
        raise SemanticError(f"{name}(geometry) takes one geometry")
    if isinstance(args[0], Constant) and isinstance(args[0].value, tuple):
        raise SemanticError(f"{name}() needs a point, not a polygon")
    return Call(DOUBLE, name, args)


def _t_st_distance(name, args):
    if len(args) != 2 or any(a.type is not GEOMETRY for a in args):
        raise SemanticError("st_distance expects two geometries")
    for a in args:
        if isinstance(a, Constant) and isinstance(a.value, tuple):
            raise SemanticError(
                "st_distance() operates on points, not polygons "
                "(use st_contains/st_within for polygon tests)")
    return Call(DOUBLE, "st_distance", args)


def _t_contains(name, args):
    if len(args) != 2:
        raise SemanticError(f"{name}() takes two geometries")
    poly, point = (args[0], args[1]) if name == "st_contains" else (args[1], args[0])
    ring = _const_geometry(poly)
    if not isinstance(ring, tuple):
        raise SemanticError(f"{name}() needs a polygon argument")
    if point.type is not GEOMETRY:
        raise SemanticError(f"{name}() second operand must be a geometry "
                            f"(got {point.type.name})")
    return Call(BOOLEAN, "st_contains_const", (Constant(GEOMETRY, ring), point))


def _t_st_area(name, args):
    if len(args) != 1:
        raise SemanticError("st_area(geometry) takes one argument")
    ring = _const_geometry(args[0])
    if not isinstance(ring, tuple):
        raise SemanticError("st_area() needs a polygon")
    return Constant(DOUBLE, _shoelace(ring))


def _t_great_circle(name, args):
    if len(args) != 4:
        raise SemanticError("great_circle_distance(lat1, lon1, lat2, lon2)")
    return Call(DOUBLE, "great_circle_distance", tuple(cast_to(a, DOUBLE) for a in args))


# --- compilers ---------------------------------------------------------------

def _c_st_point(compiler, expr):
    fx = compiler._compile(expr.args[0])[0]
    fy = compiler._compile(expr.args[1])[0]

    def fn(datas, nulls):
        x, nx = fx(datas, nulls)
        y, ny = fy(datas, nulls)
        return x + 1j * y, _or_nulls(nx, ny)
    return fn, None


def _c_coord(part):
    def compile_(compiler, expr):
        f = compiler._compile(expr.args[0])[0]

        def fn(datas, nulls):
            g, n = f(datas, nulls)
            return (torch.real(g) if part == "x" else torch.imag(g)).contiguous(), n
        return fn, None
    return compile_


def _c_st_distance(compiler, expr):
    fa = compiler._compile(expr.args[0])[0]
    fb = compiler._compile(expr.args[1])[0]

    def fn(datas, nulls):
        a, na = fa(datas, nulls)
        b, nb = fb(datas, nulls)
        return torch.abs(a - b), _or_nulls(na, nb)
    return fn, None


def _c_st_contains(compiler, expr):
    ring = expr.args[0].value
    f = compiler._compile(expr.args[1])[0]
    xs = [p[0] for p in ring]
    ys = [p[1] for p in ring]

    def fn(datas, nulls):
        g, n = f(datas, nulls)
        px, py = torch.real(g), torch.imag(g)
        inside = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
        # crossing-number test, one comparison per edge of the constant ring
        m = len(xs)
        for i in range(m):
            x1, y1 = xs[i], ys[i]
            x2, y2 = xs[(i + 1) % m], ys[(i + 1) % m]
            straddles = (y1 > py) != (y2 > py)
            dy = y2 - y1 if y2 != y1 else 1e-300
            xcross = x1 + (py - y1) * (x2 - x1) / dy
            inside = inside ^ (straddles & (px < xcross))
        return inside, n
    return fn, None


_EARTH_RADIUS_KM = 6371.01


def _c_great_circle(compiler, expr):
    fs = [compiler._compile(a)[0] for a in expr.args]

    def fn(datas, nulls):
        vals = []
        n = None
        for f in fs:
            v, nv = f(datas, nulls)
            vals.append(torch.deg2rad(v.to(torch.float64)))
            n = _or_nulls(n, nv)
        lat1, lon1, lat2, lon2 = vals
        h = torch.sin((lat2 - lat1) / 2) ** 2 + \
            torch.cos(lat1) * torch.cos(lat2) * torch.sin((lon2 - lon1) / 2) ** 2
        return 2 * _EARTH_RADIUS_KM * torch.arcsin(torch.sqrt(h)), n
    return fn, None


register_scalar_function("st_point", _t_st_point)
register_scalar_function("st_geometryfromtext", _t_st_geometryfromtext)
register_scalar_function("st_geometry_from_text", _t_st_geometryfromtext)
register_scalar_function("st_x", _t_coord)
register_scalar_function("st_y", _t_coord)
register_scalar_function("st_distance", _t_st_distance)
register_scalar_function("st_contains", _t_contains)
register_scalar_function("st_within", _t_contains)
register_scalar_function("st_area", _t_st_area)
register_scalar_function("great_circle_distance", _t_great_circle)

register_compiler("st_point", _c_st_point)
register_compiler("st_x", _c_coord("x"))
register_compiler("st_y", _c_coord("y"))
register_compiler("st_distance", _c_st_distance)
register_compiler("st_contains_const", _c_st_contains)
register_compiler("great_circle_distance", _c_great_circle)
