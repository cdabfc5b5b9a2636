"""Synthetic RDF data and workloads (the port's own copy)."""
