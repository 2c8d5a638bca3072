"""Drivers of the port: `serve_graph` (graph query serving CLI) and the
serving catalog it exposes (`catalog`), `stream_graph`, `slo_replay`,
`obs_report`, the LM serve loop `serve` (with `train.tiny_config`),
`train`, `acclint`, and the dry-run (`dryrun` over `steps`, `cost`,
`analytic` and `mesh`, reported by `roofline`)."""
