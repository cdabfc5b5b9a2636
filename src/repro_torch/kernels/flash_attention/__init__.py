"""The flash_attention kernel (``csrc/flash_attn.cu``): the dense LM's
attention forward pass in prefill."""
