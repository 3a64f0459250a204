"""LM stack of the port: layers and the decoder-only model assembly."""
