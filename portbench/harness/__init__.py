"""The port's benchmark harness: manifest, traffic, drivers, trace
reductions, work counts and the check that decides ``correct``."""
