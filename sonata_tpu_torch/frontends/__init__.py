"""User-facing frontends: CLI, gRPC server, Python API, C ABI (analogue of
``crates/frontends``)."""
