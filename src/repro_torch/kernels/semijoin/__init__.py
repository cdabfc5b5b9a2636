"""The semi-join probe kernel (``csrc/probe.cu``)."""
