"""Models of the port: the decoder-only transformer LM."""
