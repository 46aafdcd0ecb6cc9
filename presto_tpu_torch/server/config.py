"""``etc/`` configuration of the PyTorch port: ``config.properties`` and
``catalog/*.properties`` (``presto_tpu/server/config.py``).

A catalog file names its connector with ``connector.name=`` and hands every
other key to that connector's factory::

    etc/
      config.properties          # http-server.http.port=8080, session.*
      catalog/
        tpch.properties          # connector.name=tpch
        warehouse.properties     # connector.name=file
                                 # file.base-dir=/data/warehouse
      plugin/                    # optional: <name>.py or <name>/__init__.py

``FACTORIES`` holds a factory for every connector of the port (``file``,
``hive``, ``sqlite``, ``kafka``, ``raptor``, ``memory``, ``blackhole``,
``tpch``, ``tpcds``, ``remote``); ``register_connector_factory`` and the
plugins of ``load_plugins`` add more. A plugin module is imported as
``presto_tpu_torch_plugin_<name>``, so the two packages' plugins never share
a ``sys.modules`` entry. The same ``etc/`` directory gives the same catalogs
in both packages.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from ..metadata import CatalogManager, Session


def parse_properties(path: str) -> Dict[str, str]:
    """Java-style .properties subset: key=value lines, # comments."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            if "=" not in line:
                raise ValueError(f"{path}: malformed line {line!r}")
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip()
    return out


def _file_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.file import FileConnector

    base = config.get("file.base-dir")
    if not base:
        raise ValueError(f"catalog {catalog}: file.base-dir is required")
    return FileConnector(catalog, base,
                         write_format=config.get("file.format", "pcol"))


def _hive_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.hive import HiveConnector

    base = config.get("hive.metastore.catalog.dir")
    if not base:
        raise ValueError(
            f"catalog {catalog}: hive.metastore.catalog.dir is required")
    return HiveConnector(catalog, base)


def _sqlite_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.dbapi import sqlite_connector

    path = config.get("sqlite.path")
    if not path:
        raise ValueError(f"catalog {catalog}: sqlite.path is required")
    return sqlite_connector(catalog, path)


def _kafka_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.kafka import KafkaConnector

    base = config.get("kafka.log.dir")
    if not base:
        raise ValueError(f"catalog {catalog}: kafka.log.dir is required")
    return KafkaConnector(catalog, base,
                          config.get("kafka.default-schema", "default"))


def _raptor_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.raptor import RaptorConnector

    base = config.get("raptor.data.dir")
    if not base:
        raise ValueError(f"catalog {catalog}: raptor.data.dir is required")
    return RaptorConnector(
        catalog, base,
        compaction_threshold_rows=int(
            config.get("raptor.compaction.threshold-rows", 1 << 17)),
        organize_interval_s=float(
            config.get("raptor.organization.interval-seconds", 0)))


def _memory_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.memory import MemoryConnector

    return MemoryConnector(catalog)


def _blackhole_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.blackhole import BlackholeConnector

    return BlackholeConnector(catalog)


def _tpch_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.tpch.connector import TpchConnectorFactory

    return TpchConnectorFactory().create(catalog, config)


def _tpcds_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.tpcds.connector import TpcdsConnectorFactory

    return TpcdsConnectorFactory().create(catalog, config)


def _remote_factory(catalog: str, config: Dict[str, str]):
    from ..connectors.remote import RemoteConnector

    uris = config.get("remote.uri")
    if not uris:
        raise ValueError(f"catalog {catalog}: remote.uri is required")
    timeout = float(config.get("remote.timeout-s", "30"))
    return RemoteConnector(catalog, [u.strip() for u in uris.split(",")],
                           timeout_s=timeout)


FACTORIES: Dict[str, Callable] = {
    "tpch": _tpch_factory,
    "remote": _remote_factory,
    "tpcds": _tpcds_factory,
    "memory": _memory_factory,
    "blackhole": _blackhole_factory,
    "file": _file_factory,
    "hive": _hive_factory,
    "kafka": _kafka_factory,
    "sqlite": _sqlite_factory,
    "raptor": _raptor_factory,
}


def register_connector_factory(name: str, factory: Callable) -> None:
    """Plugin hook: factory(catalog_name, config) -> Connector."""
    FACTORIES[name] = factory


def load_plugins(plugin_dir: str) -> list:
    """Load external plugins from a directory.

    Each ``<plugin_dir>/<name>.py`` (or ``<name>/__init__.py``) is imported
    under ``presto_tpu_torch_plugin_<name>``; every spi.connector.Plugin subclass
    found in it is instantiated and its contributions registered:
    connector factories into FACTORIES, functions into the scalar/aggregate
    registry. Returns the Plugin instances (the plugin-toolkit contract:
    drop a file in, name its connector in etc/catalog/*.properties).
    """
    import importlib.util
    import inspect

    from ..spi.connector import ConnectorFactory, Plugin

    loaded = []
    if not os.path.isdir(plugin_dir):
        return loaded
    for entry in sorted(os.listdir(plugin_dir)):
        path = os.path.join(plugin_dir, entry)
        if entry.endswith(".py"):
            mod_name, file = entry[:-3], path
        elif os.path.isfile(os.path.join(path, "__init__.py")):
            mod_name, file = entry, os.path.join(path, "__init__.py")
        else:
            continue
        spec = importlib.util.spec_from_file_location(
            f"presto_tpu_torch_plugin_{mod_name}", file)
        module = importlib.util.module_from_spec(spec)
        # package-style plugins resolve their own relative imports through
        # sys.modules — register BEFORE exec (the standard importlib recipe)
        import sys

        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        for _n, cls in inspect.getmembers(module, inspect.isclass):
            if not (issubclass(cls, Plugin) and cls is not Plugin
                    and cls.__module__ == module.__name__):
                continue
            plugin = cls()
            for fac in plugin.connector_factories():
                if isinstance(fac, ConnectorFactory):
                    FACTORIES[fac.name] = fac.create
                else:  # (name, callable) pair
                    FACTORIES[fac[0]] = fac[1]
            for hook in plugin.functions():
                # zero-arg registration hooks: plugins call
                # sql.analyzer.register_scalar_function /
                # ops.expressions.register_compiler themselves (the same
                # registries presto_tpu_torch.functions.* use)
                if callable(hook):
                    hook()
            loaded.append(plugin)
    return loaded


def load_plugins_for_etc(etc_dir: str) -> list:
    """Load plugins for BOTH supported layouts: <install>/plugin (the dist
    layout, sibling of etc/) and <etc>/plugin."""
    loaded = load_plugins(os.path.join(
        os.path.dirname(os.path.abspath(etc_dir)), "plugin"))
    loaded += load_plugins(os.path.join(etc_dir, "plugin"))
    return loaded


def load_catalogs(etc_dir: str) -> CatalogManager:
    """Build a CatalogManager from etc/catalog/*.properties."""
    catalogs = CatalogManager()
    cat_dir = os.path.join(etc_dir, "catalog")
    if not os.path.isdir(cat_dir):
        return catalogs
    for fname in sorted(os.listdir(cat_dir)):
        if not fname.endswith(".properties"):
            continue
        catalog = fname[: -len(".properties")]
        props = parse_properties(os.path.join(cat_dir, fname))
        name = props.pop("connector.name", None)
        if name is None:
            raise ValueError(f"{fname}: missing connector.name")
        factory = FACTORIES.get(name)
        if factory is None:
            raise ValueError(
                f"{fname}: unknown connector {name!r} "
                f"(registered: {sorted(FACTORIES)})")
        catalogs.register(catalog, factory(catalog, props))
    return catalogs


def load_config(etc_dir: str) -> Dict[str, str]:
    path = os.path.join(etc_dir, "config.properties")
    return parse_properties(path) if os.path.isfile(path) else {}


def session_from_config(config: Dict[str, str]) -> Session:
    """config.properties session defaults -> Session (session.* keys become
    session properties; the SystemSessionProperties defaults fill the rest)."""
    props = {}
    for k, v in config.items():
        if not k.startswith("session.") or k in ("session.catalog",
                                                 "session.schema"):
            continue
        key = k[len("session."):].replace("-", "_")
        props[key] = int(v) if v.lstrip("-").isdigit() else v
    return Session(user=config.get("node.user", "user"),
                   catalog=config.get("session.catalog", None) or
                   config.get("default-catalog", None),
                   schema=config.get("session.schema", None) or
                   config.get("default-schema", None),
                   properties=props)
