"""The benchmark's harness: spec loading, traffic, the served run, the
comparison and the readings. It finds each configuration, cell, query and
per-layer metric by its name in a file of its own."""
