"""Server layer of the PyTorch port: the /v1/statement protocol, the query
manager, resource groups, ``etc/`` configuration and the proxy.

``python -m presto_tpu_torch.server --etc DIR`` boots the HTTP coordinator on
the card (``--device cpu`` for the CPU); see http_server.py for the
endpoints and protocol.py for the wire contract.
"""
from .http_server import PrestoTpuServer, main
from .protocol import QueryManager

__all__ = ["PrestoTpuServer", "QueryManager", "main"]
