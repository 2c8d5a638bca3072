"""Transformer building blocks of the port (`repro.nn` counterparts):
`layers` (norm, rotary, SwiGLU, GQA attention, cross-entropy) and
`chunked_attn` (the long-sequence attention path)."""
