"""Synthetic data made on the host with numpy: graphs (R-MAT, Zipf) and
the token pipeline of LM training (``tokens.py``)."""
