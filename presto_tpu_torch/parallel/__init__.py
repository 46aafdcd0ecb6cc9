"""The multi-worker engine of the PyTorch port: the mesh of logical workers
(``mesh.py``), the collective exchanges over it (``exchange.py``), the SPMD
stage programs (``distributed.py``), the streaming exchange between
fragments (``streaming_exchange.py``) and ``DistributedQueryRunner``
(``runner.py``)."""
