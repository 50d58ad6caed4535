"""Models of the port (counterpart of :mod:`apex_tpu.models`); so far
GPT's serving forward."""
