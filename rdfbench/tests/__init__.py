"""CPU tests of the benchmark, collected by ``python -m pytest`` from the
repository's root; tests that need the card carry the ``cuda`` marker."""
