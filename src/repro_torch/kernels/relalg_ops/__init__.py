"""The relational-algebra kernels: expand, bucket_by_dest, unique_compact
(``csrc/expand.cu``, ``csrc/bucket.cu``, ``csrc/compact.cu``)."""
