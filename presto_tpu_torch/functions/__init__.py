"""The plugin function libraries of the PyTorch port.

Counterpart of ``presto_tpu/functions/``: each module registers its
functions into the two extension registries, ``sql/analyzer.py``
``EXTERNAL_FUNCTIONS`` (typing) and ``ops/expressions.py``
``EXTERNAL_COMPILERS`` (compiling), and the ml module its aggregates into
``ops/aggregates.py`` ``EXTERNAL_AGGREGATES``.

- geospatial: ``ST_*`` over planar points, WKT polygon constants,
  ``great_circle_distance``;
- teradata: ``index``/``strpos``, ``char2hexint``, ``reverse``, the trims,
  ``char_length``;
- ml: ``regr_*`` and ``learn_*`` aggregates, ``regress``/``classify``.

``import presto_tpu_torch`` imports this package, so all of them are
registered, as ``import presto_tpu`` registers the reference's.
"""
from . import geospatial  # noqa: F401
from . import ml  # noqa: F401
from . import teradata  # noqa: F401
