"""Models of the port (counterpart of :mod:`apex_tpu.models`); so far
GPT on one device: serving and the training loss."""
