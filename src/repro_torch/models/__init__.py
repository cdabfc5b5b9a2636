"""Dense decoder-only LM, PyTorch port of ``repro.models``.

Modules (each the counterpart of the same name in ``repro.models``):
  common       config schema, rms_norm, RoPE, dense_init
  attention    GQA prefill attention (flash_attention kernel) and decode
  mlp          SwiGLU
  embedding    token embedding and LM head
  transformer  the dense LM: init, forward, chunked loss, decode step
  model_zoo    ModelAPI / build_model
  convert      the JAX package's parameter pytree -> the port's modules
"""
