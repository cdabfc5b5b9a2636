"""The plain reference: basic graph patterns evaluated in NumPy.

Imports nothing of the program; reads only the triples the benchmark made
and the queries as JSON.
"""
from rdfbench.reference.bgp import TripleIndex, evaluate

__all__ = ["TripleIndex", "evaluate"]
