"""Drivers of the port: `serve_graph` (graph query serving CLI) and the
serving catalog it exposes (`catalog`), `stream_graph`, `slo_replay`,
`obs_report`, and the LM serve loop `serve` (with `train.tiny_config`)."""
