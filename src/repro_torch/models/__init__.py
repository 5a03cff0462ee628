"""The language models: configuration, parameters, layers and the model
assembly (port of ``src/repro/models/``; this slice: the dense family,
ROADMAP A15a; its training, A15b)."""
