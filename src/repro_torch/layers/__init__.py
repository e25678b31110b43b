"""LM layers of the port: norms and init helpers, RoPE, SwiGLU, GQA."""
