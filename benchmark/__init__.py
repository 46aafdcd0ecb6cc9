"""The benchmark of presto_tpu_torch: TPC-H query streams through the served path."""
