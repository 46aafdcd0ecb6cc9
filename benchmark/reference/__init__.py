"""Plain numpy reference of the benchmark's TPC-H queries over a frozen copy of
the generator. It imports neither the program nor JAX."""
