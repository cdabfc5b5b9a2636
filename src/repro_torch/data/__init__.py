"""Synthetic RDF data and workloads, and LM token streams (the port's own
copies)."""
