"""Transformer building blocks of the port (`repro.nn` counterparts):
`layers` (norm, rotary, SwiGLU, GQA attention, cross-entropy),
`chunked_attn` (the long-sequence attention path) and `moe` (sort-based
top-k MoE)."""
