"""Optimizer and gradient compression of the LM training path.

The port's counterpart of ``repro.optim``: AdamW with global-norm clipping
(``adamw``) and int8 error-feedback compression of a data-parallel
all-reduce (``compression``).
"""
