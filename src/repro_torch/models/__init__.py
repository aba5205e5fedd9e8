"""The LM side of the port: parameter trees, layers and the decoder-only
model (dense archs)."""
