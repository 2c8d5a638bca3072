"""Drivers of the port: `serve_graph` (graph query serving CLI) and the
serving catalog it exposes (`catalog`)."""
